"""Input instances of the paper, in numpy (no torch, no jax)."""
from .distributions import INSTANCES, generate_instance  # noqa: F401
