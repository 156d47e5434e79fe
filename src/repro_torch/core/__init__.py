"""repro_torch.core — ``psort`` over PE-batched tensors (the sim backend)
in PyTorch, every algorithm of the reference, the external (out-of-core)
lane and the fault lane, and the sort-free query paths over resident
data."""
from .api import SortConfig, default_mesh, psort, trace_collectives  # noqa: F401
from .external import ExternalPolicy  # noqa: F401
from .types import (SortShard, int_to_key, key_to_int, key_to_uint,  # noqa: F401
                    local_sort, make_shard, merge_shards, shard_from_numpy,
                    shard_to_numpy, uint_to_key, LocalKernelPolicy,
                    local_kernels, set_local_kernels)
from .selection import select_algorithm, cost_select  # noqa: F401
from .queries import (ResidentData, percentile, range_query,  # noqa: F401
                      rank_of_key, select_rank, shard_data, top_k,
                      trace_query)
