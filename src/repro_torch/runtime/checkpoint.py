"""Atomic, async checkpointing (counterpart of
``repro/runtime/checkpoint.py``), in the reference's layout:

  <dir>/step_000000123/
      manifest.json   — step, a description of the tree, and each leaf's
                        shape, dtype and crc32
      leaf_<k>.npy    — one file per leaf, in ``jax.tree.flatten``'s order
      _COMMITTED      — written last; restore ignores dirs without it
                        (atomicity under a crash during a save)

A state is any tree of ``repro_torch.optim.tree``; a ``TrainState``
holding the port's model writes the reference's ``TrainState`` leaves,
block leaves stacked as (L, …), so each package restores the other's
checkpoints.  bfloat16 is stored as its 16-bit pattern and labelled
``"bfloat16"``.  ``save_async`` copies the state to the host once, then
writes it on a background thread while the next steps run.  ``restore``
writes tensors (and a model's weights) in place.

On a mesh (``CheckpointManager(dir, mesh=mesh)``, every rank of it
calling alike) a state holds each rank's slices, and ``save`` takes their
``shardings`` (``launch.steps.state_shardings``): every leaf is gathered
whole, a collective run by every rank on the calling thread before any
background write, and one rank (the mesh's first) writes the whole
leaves, the reference's layout.  ``wait`` and ``latest_step`` end with a
barrier of the mesh, so every rank sees a commit before it reads the
latest step.  ``restore(state_like, step, shardings)`` reads the whole
leaves on every rank and keeps the slices ``shardings`` gives it, on any
mesh (the reference's elastic restore).
"""
from __future__ import annotations

import json
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np

from repro_torch.optim import tree as tr


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, mesh=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.mesh = mesh
        self.writer = mesh is None or not any(mesh.get_coordinate())
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, blocking: bool = True,
             shardings: Any = None):
        """Write ``state`` as step ``step``; on a mesh, with the
        ``shardings`` of its leaves (collective)."""
        if shardings is None:
            host = [tr.host_leaf(leaf) for leaf in tr.leaves(state)]
        else:
            host = []
            for leaf, sh in zip(tr.leaves(state), tr.leaves(shardings)):
                whole = leaf if sh is None else sh.whole(leaf)
                host.append(tr.host_leaf(whole) if self.writer else None)
                del whole
        if not self.writer:
            return
        if blocking:
            self._write(step, host)
        else:
            self.wait(barrier=False)
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def save_async(self, step: int, state: Any, shardings: Any = None):
        self.save(step, state, blocking=False, shardings=shardings)

    def wait(self, *, barrier: bool = True):
        """Join the background write; on a mesh then meet every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if barrier and self.mesh is not None:
            from repro_torch.dist.sharding import mesh_barrier
            mesh_barrier(self.mesh)

    def _write(self, step: int, host):
        tmp = self.dir / f".tmp_step_{step:09d}"
        final = self.dir / f"step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step,
                    "treedef": f"repro_torch: {len(host)} leaves in "
                               f"jax.tree.flatten order",
                    "leaves": []}
        for k, (arr, logical) in enumerate(host):
            np.save(tmp / f"leaf_{k}.npy", arr)
            manifest["leaves"].append({"shape": list(arr.shape),
                                       "dtype": logical, "crc": _crc(arr)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "_COMMITTED").touch()
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in self.dir.glob("step_*"):
            if (d / "_COMMITTED").exists():
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The latest committed step; on a mesh, after every write of
        the mesh has committed (collective)."""
        if self.mesh is not None:
            self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``state_like``: its tensors are
        overwritten in place, its numbers replaced; returns the
        structure.  With ``shardings`` (a tree of the leaves' ``Sharding``
        on the target mesh) each leaf keeps this rank's slice of the
        whole one read.  Raises ``IOError`` on a crc mismatch."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        n_like = len(tr.leaves(state_like))
        if len(manifest["leaves"]) != n_like:
            raise ValueError("checkpoint/state structure mismatch: "
                             f"{len(manifest['leaves'])} vs {n_like}")
        k = iter(range(n_like))

        def load(like, sh=None):
            i = next(k)
            meta = manifest["leaves"][i]
            arr = np.load(d / f"leaf_{i}.npy")
            if _crc(arr) != meta["crc"]:
                raise IOError(f"checkpoint corruption in leaf_{i}")
            if sh is not None and arr.ndim:
                arr = arr[sh.slices(arr.shape)]
            want = tuple(getattr(like, "shape", np.shape(like)))
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf_{i} shape {arr.shape} != {want}")
            return tr.load_leaf(like, arr, meta["dtype"])
        if shardings is None:
            return tr.map_leaves(load, state_like)
        return tr.map_with(load, state_like, shardings)
