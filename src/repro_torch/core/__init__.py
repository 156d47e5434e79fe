"""repro_torch.core — ``psort`` over PE-batched tensors (the sim backend)
in PyTorch, every algorithm of the reference and the external
(out-of-core) lane, and the sort-free query paths over resident data."""
from .api import SortConfig, psort, trace_collectives  # noqa: F401
from .external import ExternalPolicy  # noqa: F401
from .types import (SortShard, int_to_key, key_to_int, local_sort,  # noqa: F401
                    make_shard, shard_from_numpy, shard_to_numpy)
from .queries import (ResidentData, percentile, range_query,  # noqa: F401
                      rank_of_key, select_rank, shard_data, top_k,
                      trace_query)
