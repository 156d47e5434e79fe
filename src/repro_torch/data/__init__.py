"""Input instances of the paper, in numpy (no torch, no jax), and the
token pipeline with its length-balanced batching (``pipeline``)."""
from .distributions import INSTANCES, generate_instance  # noqa: F401
from .pipeline import TokenPipeline, length_balanced_batches  # noqa: F401
