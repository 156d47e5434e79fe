"""Sort-as-a-service: a continuous-batching query frontend over the port's
resident data (counterpart of ``repro/launch/sort_serve.py``).

Requests (``sort`` / ``top_k`` / ``rank_of_key`` / ``percentile`` /
``range_query``) arrive on a FIFO queue; :class:`SortService` drains them
in micro-batches: each :meth:`SortService.step` takes the kind at the head
of the queue, collects every queued request of that kind (up to
``max_batch``, FIFO order kept) and answers the group with one batched
call of ``repro_torch.core.queries``.  Each request of a batch is charged
the batch's time; its latency adds its queue wait.

Per query kind the service routes between two paths:

  * **selection**: the sort-free primitives of ``core/queries.py`` over
    the resident data on the device;
  * **fullsort**: answers read from a sorted copy, the port's ``psort``
    output, built on first use and kept on the device.

``policy="auto"`` asks ``selection.select_algorithm(query=...)``, which
charges a full sort to the batch.  The service runs on the card unless the
caller passes ``device="cpu"``.  A step's clock stops once its answers are
on the host, or, for ``sort`` requests, after the device finished.
``backend="shard_map"`` answers on ``torch.distributed``, one PE per rank:
every rank runs the service on the same stream (SPMD), and the CLI joins
the process group ``torchrun`` describes (gloo with ``--device cpu``,
NCCL on the card).

  PYTHONPATH=src python -m repro_torch.launch.sort_serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.sort_serve --smoke \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.sort_serve --n 1048576 \\
      --p 64 --queries 200 \\
      --mix top_k=4,percentile=2,rank_of_key=2,range_query=1
  PYTHONPATH=src torchrun --nproc-per-node=8 -m \
      repro_torch.launch.sort_serve --smoke --backend shard_map \
      --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import SortConfig, psort, queries, selection
from repro_torch.core.queries import QUERY_KINDS
from repro_torch.core.types import key_to_int


def latency_stats(lat, warmup: int = 1, rate_scale: float = 1.0,
                  note_ctx: str = "sample") -> Dict[str, Any]:
    """Percentile summary of a latency series, robust to tiny samples.

    Drops the ``warmup`` leading samples; when nothing remains the stats
    are ``None`` with an explanatory ``note``.  ``rate_scale`` converts
    the mean latency into a rate (the items one sample covers)."""
    lat = np.asarray(lat, dtype=float)
    post = lat[warmup:]
    if post.size == 0:
        return {"p50_ms": None, "p99_ms": None, "per_s": None,
                "n": int(lat.size),
                "note": f"{lat.size} {note_ctx}(s) <= warmup={warmup}: "
                        "not enough post-warmup samples for percentiles"}
    return {"p50_ms": float(np.percentile(post, 50) * 1e3),
            "p99_ms": float(np.percentile(post, 99) * 1e3),
            "per_s": float(rate_scale / post.mean()),
            "n": int(post.size)}


_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One queued query.  ``arg`` per kind: top_k → k, percentile → q,
    rank_of_key → key, range_query → (lo, hi), sort → None."""
    kind: str
    arg: Any = None
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    t_submit: float = 0.0


@dataclasses.dataclass
class Result:
    request: Request
    value: Any
    path: str                 # "selection" | "fullsort" | "sort"
    batch: int                # micro-batch size this request rode in
    step_s: float             # time of the batched call
    latency_s: float          # submit → done (includes queue wait)


def _signed(t: torch.Tensor) -> torch.Tensor:
    """A key tensor's bits as int32 / int64 (gathers on the card take no
    unsigned dtype)."""
    return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    """A key tensor's bits as a numpy array of the keys' ``dtype``."""
    return _signed(t).cpu().numpy().view(dtype)


class SortService:
    """Continuous-batching query service over one resident dataset."""

    def __init__(self, keys, p: Optional[int] = None, *,
                 config: Optional[SortConfig] = None, backend: str = "sim",
                 axis: str = "sort", mesh=None, policy: str = "auto",
                 model: Optional[selection.CostModel] = None,
                 max_batch: int = 64, clock=time.perf_counter,
                 device=None):
        """``config`` carries the sort knobs (p, the algorithm of the
        fullsort copy, the cost model of ``"auto"``); the direct keywords
        are the reference's legacy spelling.  ``policy``, ``max_batch``,
        ``clock`` and ``device`` are the service's own."""
        if policy not in ("auto", "selection", "fullsort"):
            raise ValueError(f"unknown policy {policy!r}")
        if config is None:
            config = SortConfig(p=p, backend=backend, axis=axis, mesh=mesh,
                                cost_model=model)
        elif p is not None and config.p not in (None, p):
            raise ValueError(f"p={p} inconsistent with config.p={config.p}")
        elif config.p is None and p is not None:
            config = config.replace(p=p)
        if config.p is None:
            raise ValueError("SortService needs p (directly or via config)")
        self.config = config
        self.keys = keys if isinstance(keys, torch.Tensor) \
            else np.asarray(keys)
        self.data = queries.shard_data(self.keys, config.p, device=device)
        self.device = self.data.device
        self.backend = config.backend
        self.axis = axis
        self.mesh = mesh
        self.policy = policy
        self.model = config.cost_model
        self.max_batch = max_batch
        self.clock = clock
        self.queue: deque = deque()
        self.completed: List[Result] = []
        self._sorted: Optional[torch.Tensor] = None   # lazy fullsort copy
        self._search: Optional[torch.Tensor] = None   # its search order
        self._bits = self.data.bits

    # -- request intake ---------------------------------------------------

    def submit(self, kind: str, arg: Any = None) -> int:
        if kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {kind!r}; "
                             f"know {QUERY_KINDS}")
        req = Request(kind, arg, t_submit=self.clock())
        self.queue.append(req)
        return req.id

    # -- routing ----------------------------------------------------------

    def route(self, kind: str, batch: int) -> str:
        """Which path a micro-batch takes: the policy, or under ``"auto"``
        the cost model's verdict.  As in the reference, the top-k
        arguments it weighs are those still queued after the batch left
        the queue."""
        if kind == "sort":
            return "sort"
        if self.policy != "auto":
            return self.policy
        ks = [r.arg for r in self.queue if r.kind == "top_k"]
        verdict = selection.select_algorithm(
            self.data.n, self.data.p, config=self.config, query=kind,
            batch=batch, k=max(ks) if ks else None, bits=self._bits)
        return "selection" if verdict == "selection" else "fullsort"

    # -- execution --------------------------------------------------------

    def _full_sorted(self) -> torch.Tensor:
        if self._sorted is None:
            self._sorted = psort(self.keys,
                                 config=self.config.replace(p=self.data.p),
                                 device=self.device)
            # np.searchsorted compares float keys as floats, others as
            # their words (the keys' own order)
            self._search = self._sorted if self._sorted.is_floating_point() \
                else key_to_int(self._sorted)
        return self._sorted

    def _searchsorted(self, a: np.ndarray, side: str) -> torch.Tensor:
        x = queries._upload(self.device, a)[0] if a.dtype.kind == "f" \
            else queries._words_of(a, self.device)
        return torch.searchsorted(self._search, x, side=side)

    def _answer_selection(self, kind: str, args: list):
        kw = dict(backend=self.backend, axis=self.axis, mesh=self.mesh)
        if kind == "top_k":
            out = queries.top_k(self.data, np.asarray(args, np.int64), **kw)
            return list(out)
        if kind == "percentile":
            return list(queries.percentile(self.data,
                                           np.asarray(args, float), **kw))
        if kind == "rank_of_key":
            lt, le = queries.rank_of_key(self.data, np.asarray(args), **kw)
            return list(zip(lt.tolist(), le.tolist()))
        lo = np.asarray([a[0] for a in args])
        hi = np.asarray([a[1] for a in args])
        return list(queries.range_query(self.data, lo, hi, **kw))

    def _answer_fullsort(self, kind: str, args: list):
        s = self._full_sorted()
        n = len(s)
        dtype = queries._np_dtype(s)
        if kind == "top_k":
            starts = [slice(n - int(k), None).indices(n)[0] for k in args]
            tail = _host(s[min(starts):], dtype)
            return [tail[a - min(starts):] for a in starts]
        if kind == "percentile":
            idx = np.floor(np.asarray(args, float) / 100.0 * (n - 1))
            idx = queries._upload(self.device, idx.astype(np.int64))[0]
            return list(_host(_signed(s)[idx], dtype))
        if kind == "rank_of_key":
            a = np.asarray(args, dtype)
            ranks = torch.stack([self._searchsorted(a, "left"),
                                 self._searchsorted(a, "right")])
            lt, le = ranks.cpu().numpy()
            return list(zip(lt.tolist(), le.tolist()))
        lo = np.asarray([a[0] for a in args], dtype)
        hi = np.asarray([a[1] for a in args], dtype)
        cnt = self._searchsorted(hi, "left") - self._searchsorted(lo, "left")
        return list(np.maximum(cnt.cpu().numpy(), 0))

    def step(self) -> List[Result]:
        """Drain one micro-batch: the head-of-queue kind, FIFO, up to
        ``max_batch`` requests, one batched call."""
        if not self.queue:
            return []
        kind = self.queue[0].kind
        batch: List[Request] = []
        rest: deque = deque()
        while self.queue and len(batch) < self.max_batch:
            r = self.queue.popleft()
            (batch if r.kind == kind else rest).append(r)
        while self.queue:
            rest.append(self.queue.popleft())
        self.queue = rest
        path = self.route(kind, len(batch))
        t0 = self.clock()
        if kind == "sort":
            vals = [self._full_sorted() for _ in batch]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        elif path == "selection":
            vals = self._answer_selection(kind, [r.arg for r in batch])
        else:
            vals = self._answer_fullsort(kind, [r.arg for r in batch])
        t1 = self.clock()
        out = [Result(r, v, path, len(batch), t1 - t0, t1 - r.t_submit)
               for r, v in zip(batch, vals)]
        self.completed.extend(out)
        return out

    def drain(self) -> List[Result]:
        done: List[Result] = []
        while self.queue:
            done.extend(self.step())
        return done

    # -- reporting --------------------------------------------------------

    def stats(self, warmup: int = 1) -> Dict[str, Dict[str, Any]]:
        """Per-kind end-to-end latency stats over completed requests, plus
        an overall block with queries/s over the batches' time (each
        batch counted once: steps are told apart by kind and time to the
        nanosecond, as in the reference)."""
        out: Dict[str, Dict[str, Any]] = {}
        for kind in QUERY_KINDS:
            lat = [r.latency_s for r in self.completed
                   if r.request.kind == kind]
            if lat:
                out[kind] = latency_stats(lat, warmup=warmup,
                                          note_ctx="request")
        all_lat = [r.latency_s for r in self.completed]
        if all_lat:
            total = latency_stats(all_lat, warmup=warmup,
                                  note_ctx="request")
            steps = {}
            for r in self.completed:
                steps.setdefault((r.request.kind, round(r.step_s, 9)),
                                 r.step_s)
            busy = sum(steps.values())
            total["queries_per_s"] = (len(all_lat) / busy) if busy > 0 \
                else None
            out["overall"] = total
        return out


# ---------------------------------------------------------------------------
# The command line: a synthetic mixed-query stream
# ---------------------------------------------------------------------------


def _gen_stream(rng, n, count, mix: Dict[str, int], key_pool):
    kinds = [k for k, w in mix.items() for _ in range(w)]
    for _ in range(count):
        kind = kinds[rng.integers(len(kinds))]
        if kind == "top_k":
            yield kind, int(rng.integers(1, min(64, n) + 1))
        elif kind == "percentile":
            yield kind, float(rng.uniform(0, 100))
        elif kind == "rank_of_key":
            yield kind, key_pool[rng.integers(len(key_pool))]
        elif kind == "range_query":
            a = key_pool[rng.integers(len(key_pool))]
            b = key_pool[rng.integers(len(key_pool))]
            yield kind, (min(a, b), max(a, b))
        else:
            yield kind, None


def parse_mix(text: str) -> Dict[str, int]:
    mix = {}
    for part in text.split(","):
        k, _, w = part.partition("=")
        k = k.strip()
        if k not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {k!r} in --mix")
        mix[k] = int(w) if w else 1
    return mix


def _join_ranks(device) -> None:
    """Join the process group ``torchrun`` describes in the environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), unless one is up: gloo
    for the CPU, NCCL for the card."""
    import torch.distributed as dist
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    dist.init_process_group("gloo" if device == "cpu" else "nccl")


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--p", type=int, default=64)
    ap.add_argument("--queries", type=int, default=None,
                    help="query count (default 100; 24 under --smoke)")
    ap.add_argument("--mix", default="top_k=4,percentile=2,rank_of_key=2,"
                                     "range_query=1")
    ap.add_argument("--policy", default="auto",
                    choices=("auto", "selection", "fullsort"))
    ap.add_argument("--backend", default="sim",
                    choices=("sim", "shard_map"))
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny instance: n=4096, p=8, 24 queries")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.p = 4096, 8
    if args.queries is None:
        args.queries = 24 if args.smoke else 100

    if args.backend == "shard_map":
        _join_ranks(args.device)
    rng = np.random.default_rng(args.seed)
    keys = rng.integers(0, 1 << 32, size=args.n).astype(np.int64)
    svc = SortService(keys, config=SortConfig(p=args.p,
                                              backend=args.backend),
                      policy=args.policy, max_batch=args.max_batch,
                      device=args.device)
    mix = parse_mix(args.mix)
    pool = keys[rng.integers(0, args.n, size=256)]
    for kind, arg in _gen_stream(rng, args.n, args.queries, mix, pool):
        svc.submit(kind, arg)
    t0 = time.perf_counter()
    done = svc.drain()
    wall = time.perf_counter() - t0
    if _rank() != 0:                        # every rank holds the answers
        return svc
    print(f"[sort_serve] n={args.n} p={args.p} backend={args.backend} "
          f"policy={args.policy} device={svc.device}: {len(done)} queries "
          f"in {wall:.3f}s")
    for kind, st in svc.stats().items():
        if st.get("p50_ms") is None:
            print(f"  {kind:>12}: n={st['n']}  ({st['note']})")
            continue
        extra = f"  {st['queries_per_s']:.1f} q/s" \
            if st.get("queries_per_s") else ""
        print(f"  {kind:>12}: n={st['n']}  p50 {st['p50_ms']:.2f}ms  "
              f"p99 {st['p99_ms']:.2f}ms{extra}")
    return svc


if __name__ == "__main__":
    main()
