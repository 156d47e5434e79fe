"""repro_torch.dist — the sorting meshes of the distributed backend
(``sharding.sort_mesh``).  The model stack's sharding rules are ROADMAP
queue 1 item 10c (serving on a mesh)."""
from .sharding import sort_mesh  # noqa: F401
