"""repro_torch.dist — the sorting meshes of the distributed backend
(``sort_mesh``) and the model stack's sharding rules (``make_shardings``,
``shard_act``, ``data_axes_of``, ``batch_axes_of``)."""
from .sharding import (batch_axes_of, data_axes_of, make_shardings,  # noqa: F401
                       shard_act, sort_mesh)
