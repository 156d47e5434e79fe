"""repro_torch.dist — the sorting meshes of the distributed backend
(``sharding.sort_mesh``).  The model stack's sharding rules come with the
integration stack, ROADMAP queue 1 item 10."""
from .sharding import sort_mesh  # noqa: F401
