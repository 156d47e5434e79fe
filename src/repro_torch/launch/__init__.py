"""repro_torch.launch — entry points of the port: the sort service
(``sort_serve``), the model-serving driver (``serve``) and its steps
(``steps``)."""
