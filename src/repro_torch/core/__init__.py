"""repro_torch.core — the RAMS main path of ``psort`` over PE-batched
tensors (the sim backend), in PyTorch."""
from .api import SortConfig, psort  # noqa: F401
from .types import (SortShard, int_to_key, key_to_int, local_sort,  # noqa: F401
                    make_shard, shard_from_numpy, shard_to_numpy)
