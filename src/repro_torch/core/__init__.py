"""repro_torch.core — ``psort`` over PE-batched tensors (the sim backend)
in PyTorch: the RAMS main path and the external (out-of-core) lane."""
from .api import SortConfig, psort  # noqa: F401
from .external import ExternalPolicy  # noqa: F401
from .types import (SortShard, int_to_key, key_to_int, local_sort,  # noqa: F401
                    make_shard, shard_from_numpy, shard_to_numpy)
