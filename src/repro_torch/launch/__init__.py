"""repro_torch.launch — entry points of the port: the sort service
(``sort_serve``), model serving (``serve``), training (``train``) and
their steps (``steps``)."""
