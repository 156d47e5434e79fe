"""Fused partition-into-buckets over PE-batched shards: Hopper classify and
rank kernels (csrc/partition.cu), their plain versions (ref.py) and the
wrapper ``partition_buckets`` (ops.py)."""
from .ops import (LAUNCHES, MAX_BUCKETS, PTILE, classify,  # noqa: F401
                  partition_buckets, rank)
from .ref import partition_ref  # noqa: F401
