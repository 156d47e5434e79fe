"""Which Hopper kernels the algorithms launch: the counterpart of the
reference's local-kernel policy (``repro/core/types.py``).

``sort`` gates the local sort (``local_sort_fast``: ``tile_sort`` and
``run_merge``), ``partition`` the classifiers (``partition_buckets`` and
the external lane's ``kway_classify``), as the reference's ``partition``
gates its fused partition and k-way kernels.  A CPU tensor always takes
the plain PyTorch version; a tensor on the card always launches the
kernel.  So where the reference's switch sends its sorts to the plain
path, the port's refuses: a wrapper whose family is off raises for a
tensor on the card rather than run the plain version there.  A kernel
that fails to build or launch raises too.

The policy, by precedence: :func:`set_local_kernels` > the environment
variable ``REPRO_LOCAL_KERNELS`` > the default, with the legacy
``REPRO_PALLAS_LOCAL_SORT`` layered on ``sort``::

    REPRO_LOCAL_KERNELS=none              plain versions everywhere
    REPRO_LOCAL_KERNELS=sort,partition    both kernel families
    REPRO_LOCAL_KERNELS=all               the same
    REPRO_LOCAL_KERNELS=auto              the default: on for CUDA tensors

The reference's ``auto`` turns its kernels on where the backend is a TPU;
the port's turns them on for every tensor on the card, which is the only
device they run on.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("", "0", "none", "off", "false", "no")


@dataclasses.dataclass(frozen=True)
class LocalKernelPolicy:
    """Which kernel families are on: ``sort`` (``tile_sort`` and
    ``run_merge``) and ``partition`` (``partition_classify``,
    ``partition_rank`` and ``kway_classify``)."""

    sort: bool = False
    partition: bool = False


_OVERRIDE: Optional[LocalKernelPolicy] = None


def _default_local_kernels() -> LocalKernelPolicy:
    return LocalKernelPolicy(sort=True, partition=True)


def _parse_local_kernels(spec: str) -> LocalKernelPolicy:
    s = spec.strip().lower()
    if s == "auto":
        return _default_local_kernels()
    if s in _FALSY:
        return LocalKernelPolicy()
    if s == "all" or s in _TRUTHY:
        return LocalKernelPolicy(sort=True, partition=True)
    parts = {t.strip() for t in s.split(",") if t.strip()}
    unknown = parts - {"sort", "partition"}
    if unknown:
        raise ValueError(f"REPRO_LOCAL_KERNELS: unknown kernel(s) "
                         f"{sorted(unknown)} in {spec!r} (know: sort, "
                         f"partition, all, none, auto)")
    return LocalKernelPolicy(sort="sort" in parts,
                             partition="partition" in parts)


def local_kernels() -> LocalKernelPolicy:
    """The active policy: :func:`set_local_kernels` >
    ``REPRO_LOCAL_KERNELS`` > the default (both on, for CUDA tensors),
    with ``REPRO_PALLAS_LOCAL_SORT`` layered on ``sort``."""
    if _OVERRIDE is not None:
        return _OVERRIDE
    env = os.environ.get("REPRO_LOCAL_KERNELS")
    pol = _parse_local_kernels(env) if env is not None \
        else _default_local_kernels()
    legacy = os.environ.get("REPRO_PALLAS_LOCAL_SORT")
    if legacy is not None:
        pol = dataclasses.replace(pol, sort=legacy.lower() in _TRUTHY)
    return pol


def set_local_kernels(policy: Optional[LocalKernelPolicy]
                      ) -> Optional[LocalKernelPolicy]:
    """Force the whole policy (None: defer to the environment and the
    default again).  Returns the previous override."""
    global _OVERRIDE
    prev = _OVERRIDE
    _OVERRIDE = policy
    return prev


def plain(t, family: str) -> bool:
    """Whether a wrapper takes its plain version for tensor ``t``: only on
    the CPU.  A tensor elsewhere launches the kernel, and raises where the
    caller turned its ``family`` off."""
    if t.device.type == "cpu":
        return True
    if not getattr(local_kernels(), family):
        raise RuntimeError(
            f"the {family!r} kernels are switched off ({local_kernels()}) "
            f"but the tensor is on {t.device}: the port runs its kernels "
            f"on every tensor on the card and has no plain path there; "
            f"unset REPRO_LOCAL_KERNELS / REPRO_PALLAS_LOCAL_SORT, call "
            f"set_local_kernels(None), or sort on device='cpu'")
    return False
