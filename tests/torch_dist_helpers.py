"""Ranks of ``torch.distributed`` for the port's distributed tests.

:class:`RankPool` spawns ``world`` processes once (``spawn``, never
``fork``: the test process has JAX initialised), each joins a gloo group
on the CPU, and then runs the jobs it is sent: :meth:`RankPool.run` sends
one module-level function to every rank and returns their results in
rank order.  Every group has a timeout and every job a deadline, so a
hung collective fails its test within two minutes.  The jobs below run in
the ranks; this module imports no JAX, so a rank never loads it.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import socket
import traceback

import numpy as np

TIMEOUT_S = 60          # a collective that waits longer raises
DEADLINE_S = 110        # a job that takes longer fails its test
START_S = 90            # the ranks must be up by then


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, jobs, results):
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        results.put((rank, "ready", None))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        return
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args = job
        try:
            results.put((rank, "ok", fn(*args)))
        except BaseException:
            results.put((rank, "error", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks in one gloo group, reused across jobs."""

    def __init__(self, world: int = 8):
        ctx = multiprocessing.get_context("spawn")
        self.world = world
        self.results = ctx.Queue()
        self.jobs = [ctx.Queue() for _ in range(world)]
        port = _free_port()
        self.procs = [ctx.Process(target=_serve, daemon=True, args=(
            r, world, port, self.jobs[r], self.results))
            for r in range(world)]
        for proc in self.procs:
            proc.start()
        self.broken = None
        self._collect(START_S, "start")

    def _collect(self, deadline, what):
        out, errors = {}, []
        try:
            for _ in range(self.world):
                rank, status, value = self.results.get(timeout=deadline)
                if status == "error":
                    errors.append(f"rank {rank}:\n{value}")
                out[rank] = value
        except queue.Empty:
            silent = sorted(set(range(self.world)) - set(out))
            self.broken = (f"{what}: ranks {silent} gave no answer within "
                           f"{deadline} s")
            self.close()
            raise TimeoutError(self.broken) from None
        if errors:
            raise RuntimeError("\n".join(errors))
        return [out[r] for r in range(self.world)]

    def run(self, fn, *args):
        """``fn(*args)`` on every rank; its results in rank order."""
        self.submit(fn, *args)
        return self.collect(fn)

    def submit(self, fn, *args):
        """Send ``fn(*args)`` to every rank and return at once: the caller
        works on while the ranks run, then takes the results with
        :meth:`collect`."""
        if self.broken:
            raise RuntimeError(f"the rank pool is broken ({self.broken})")
        for q in self.jobs:
            q.put((fn, args))

    def collect(self, fn):
        """The results of the job :meth:`submit` sent, in rank order."""
        return self._collect(DEADLINE_S, fn.__name__)

    def close(self):
        for q in self.jobs:
            q.put(None)
        for proc in self.procs:
            proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join(5)


# ---------------------------------------------------------------------------
# Jobs (run in the ranks)
# ---------------------------------------------------------------------------


def _events(trace):
    return [tuple(e.__dict__.values()) for e in trace.events]


def _bits(t):
    signed = {4: "int32", 8: "int64"}[t.element_size()]
    import torch
    return t.view(getattr(torch, signed)).numpy().copy()


def _mesh(keys, cfg_kw, mesh_kw):
    """``sort_mesh(**mesh_kw)``, or the mesh psort makes by default for
    these keys and keywords (made here on every rank, as making it is
    collective; psort then finds it made)."""
    from repro_torch import SortConfig
    from repro_torch.core.api import _mesh_of
    from repro_torch.dist import sort_mesh
    if mesh_kw is not None:
        return sort_mesh(**mesh_kw)
    keys = np.asarray(keys)
    return _mesh_of(SortConfig(backend="shard_map", **cfg_kw),
                    keys.ndim == 2, keys.shape[0] if keys.ndim == 2 else 1)[0]


def sort_job(keys, cfg_kw, mesh_kw=None):
    """psort on the distributed backend: the result's bits, perm, counts,
    overflow, algorithm, backend and the trace's events, on every rank of
    the mesh (None on the others).  ``mesh_kw`` builds the mesh with
    ``sort_mesh`` first, else the default mesh of ``cfg_kw["p"]`` ranks
    is made; on every rank, since making a mesh is collective."""
    import torch.distributed as dist
    from repro_torch import SortConfig, psort
    from repro_torch.core import comm
    mesh = _mesh(keys, cfg_kw, mesh_kw)
    if dist.get_rank() not in mesh.mesh.reshape(-1).tolist():
        return None
    cfg = SortConfig(backend="shard_map", **cfg_kw,
                     mesh=mesh if mesh_kw is not None else None)
    with comm.counting() as trace:
        out, info = psort(keys, cfg, return_info=True, device="cpu")
    perm = info["perm"]
    as_list = isinstance(out, list)
    return {"out": [_bits(o) for o in out] if as_list else _bits(out),
            "perm": [q.numpy() for q in perm] if as_list else perm.numpy(),
            "counts": info["counts"].numpy(), "overflow": info["overflow"],
            "algorithm": info["algorithm"], "backend": info["backend"],
            "events": _events(trace)}


def sim_job(keys, cfg_kw):
    """The same psort on the sim backend, in a rank (no collective)."""
    from repro_torch import SortConfig, psort
    from repro_torch.core import comm
    with comm.counting() as trace:
        out, info = psort(keys, SortConfig(**cfg_kw), return_info=True,
                          device="cpu")
    return {"out": _bits(out), "perm": info["perm"].numpy(),
            "counts": info["counts"].numpy(), "overflow": info["overflow"],
            "events": _events(trace)}


def query_job(keys, p, backend, ranks, qs, ks, probes, lo, hi):
    """Every query kind over ``shard_data(keys, p)`` on ``backend``, with
    the trace of a ``select_rank``: on every rank of the default mesh of
    p ranks (None on the others, which only join its making)."""
    import torch.distributed as dist
    from repro_torch.core import comm, queries as Q
    from repro_torch.core.api import default_mesh
    if backend == "shard_map":
        mesh = default_mesh(p)
        if dist.get_rank() not in mesh.mesh.reshape(-1).tolist():
            return None
    data = Q.shard_data(keys, p, device="cpu")
    kw = {"backend": backend}
    with comm.counting() as trace:
        sel = Q.select_rank(data, ranks, **kw)
    return {"select": [np.asarray(a) for a in sel],
            "percentile": np.asarray(Q.percentile(data, qs, **kw)),
            "top_k": [np.asarray(a) for a in Q.top_k(data, ks, **kw)],
            "rank_of_key": [np.asarray(a)
                            for a in Q.rank_of_key(data, probes, **kw)],
            "range_query": np.asarray(Q.range_query(data, lo, hi, **kw)),
            "events": _events(trace)}


def collectives(comm, x, groups, perm):
    """The port's collectives on the (P, ...) values ``x`` (P = p emulated
    PEs, or a rank's one row): grouped and whole-axis psum (ints, floats,
    bools), all_gather, all_to_all, a partial ppermute, the hypercube swap
    and a streamed exchange folded in delivery order."""
    import torch
    out = {"psum": comm.psum(x), "psum_g": comm.psum(x, groups),
           "psum_f": comm.psum(x.to(torch.float32) / 7),
           "psum_fg": comm.psum(x.to(torch.float64) / 3, groups),
           "psum_b": comm.psum((x % 3) == 0, groups),
           "gather": comm.all_gather(x), "gather_g": comm.all_gather(
               x, groups, tiled=True),
           "a2a": comm.all_to_all(x), "a2a_g": comm.all_to_all(
               x[:, :len(groups[0]) * 2], groups),
           "perm": comm.ppermute(x, perm), "swap": comm.swap(x, 1)}

    def fold(acc, chunks, src):
        return acc + [chunks[0] * 10 + src[:, None]]
    g = len(groups[0])
    out["stream"] = torch.cat(comm.alltoall_stream(
        [x[:, :g * 2]], fold, [], g, groups), dim=1)
    return {k: v.numpy() for k, v in out.items()}


def collectives_job(rows, groups, perm, mesh_ranks):
    """:func:`collectives` on this rank's row of ``rows`` (PE i of the
    sort axis holds row i) inside ``comm.distributed``: over the default
    group when ``mesh_ranks`` is None, else over the 1-D mesh of those
    global ranks in that order."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.dist.sharding import make_mesh
    where = dist.group.WORLD if mesh_ranks is None else make_mesh(
        np.asarray(mesh_ranks), ("sort",))
    with comm.distributed(where) as layout:
        me = layout.axis(comm.AXIS).index
        x = torch.from_numpy(np.asarray(rows[me:me + 1]))
        return me, collectives(comm, x, groups, perm)


def mesh_job(calls):
    """``sort_mesh(**kw)`` for each kw of ``calls`` (every rank makes each
    mesh): its axis sizes and its ranks, or the error's type and
    message."""
    from repro_torch.dist import sort_mesh
    from repro_torch.dist.sharding import mesh_sizes
    out = []
    for kw in calls:
        try:
            m = sort_mesh(**kw)
            out.append((mesh_sizes(m), m.mesh.reshape(-1).tolist()))
        except Exception as e:                  # noqa: BLE001
            out.append((type(e).__name__, str(e)))
    return out


def trace_job(n, cfg_kw):
    """``trace_collectives`` on the distributed backend: this rank's events
    (None off the default mesh of ``cfg_kw["p"]`` ranks)."""
    import torch.distributed as dist
    from repro_torch import SortConfig, trace_collectives
    from repro_torch.core.api import default_mesh
    mesh = default_mesh(cfg_kw.get("p"))
    if dist.get_rank() not in mesh.mesh.reshape(-1).tolist():
        return None
    trace = trace_collectives(n, SortConfig(backend="shard_map", **cfg_kw),
                              device="cpu")
    return _events(trace)


def service_job(keys, p, stream):
    """A ``SortService`` on the distributed backend over ``keys`` at p,
    draining ``stream`` ((kind, arg) pairs) under the selection policy:
    the answers in submission order."""
    from repro_torch.launch.sort_serve import SortService
    svc = SortService(keys, p, backend="shard_map", policy="selection",
                      device="cpu")
    for kind, arg in stream:
        svc.submit(kind, arg)
    done = sorted(svc.drain(), key=lambda r: r.request.id)
    return [np.asarray(r.value).tolist() for r in done]


def cli_job(argv):
    """The serving CLI on this rank: its completed answers in order."""
    from repro_torch.launch.sort_serve import main
    svc = main(argv)
    done = sorted(svc.completed, key=lambda r: r.request.id)
    return [np.asarray(r.value).tolist() for r in done]


def error_job(keys, cfg_kw, mesh_kw=None):
    """The exception type and message of a psort, or None; ``mesh_kw``
    makes its mesh (``{"p": p}`` alone: the default mesh of p ranks)."""
    from repro_torch import SortConfig, psort
    from repro_torch.core.api import default_mesh
    from repro_torch.dist import sort_mesh
    if mesh_kw is not None:
        cfg_kw = dict(cfg_kw, mesh=default_mesh(mesh_kw["p"])
                      if list(mesh_kw) == ["p"] else sort_mesh(**mesh_kw))
    try:
        psort(keys, SortConfig(**cfg_kw), device="cpu")
    except Exception as e:                      # noqa: BLE001
        return type(e).__name__, str(e)
    return None


def same(a, b) -> bool:
    """Two results of :func:`sort_job` / :func:`sim_job` equal bit for
    bit (events too, where both have them)."""
    for k in ("out", "perm", "counts"):
        x, y = a[k], b[k]
        if isinstance(x, list) != isinstance(y, list):
            return False
        pairs = zip(x, y) if isinstance(x, list) else [(x, y)]
        if not all(np.array_equal(np.asarray(u), np.asarray(v))
                   for u, v in pairs):
            return False
    return a["overflow"] == b["overflow"] and a["events"] == b["events"]


def np_bits(a):
    a = np.asarray(a)
    return a.view({4: np.int32, 8: np.int64}[a.itemsize])


def on_ranks(results, want):
    """Every rank of the mesh got ``want`` (a :func:`sim_job` result);
    returns the sorting ranks' results."""
    sorting = [r for r in results if r is not None]
    assert sorting
    for r in sorting:
        assert r["backend"] == "shard_map"
        assert same(r, want)
    return sorting


def as_reference(r, out, info):
    """A rank's result bit for bit the reference's (keys, perm, counts,
    overflow)."""
    assert np.array_equal(np.asarray(r["out"]), np_bits(out))
    assert np.array_equal(np.asarray(r["perm"]),
                          np.asarray(info["perm"]).astype(np.int64))
    assert np.array_equal(np.asarray(r["counts"]), np.asarray(info["counts"]))
    assert r["overflow"] == info["overflow"]
    assert r["algorithm"] == info["algorithm"]


def moe_job(arch, dtype, x, params, layout, kw):
    """The MoE dispatch on a (data, model) mesh of ``layout`` = (d, m)
    ranks: ``moe_ep_shardmap`` and ``moe_tp_shardmap`` on the smoke
    config of ``arch`` in ``dtype``, on every rank of the mesh (None on
    the others): (y_ep, aux_ep, y_tp, aux_tp) as float32 numpy arrays and
    the bits of y_ep."""
    import dataclasses
    from types import SimpleNamespace

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.models import moe
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype)
    dt = getattr(torch, dtype)
    d, m = layout
    mesh = make_mesh(np.arange(d * m).reshape(d, m), ("data", "model"))
    if dist.get_rank() >= d * m:
        return None
    p = SimpleNamespace(**{k: torch.from_numpy(v).to(
        torch.float32 if k == "router" else dt) for k, v in params.items()})
    xt = torch.from_numpy(x).to(dt)
    y_ep, aux_ep = moe.moe_ep_shardmap(xt, p, cfg, mesh, data_axes=("data",),
                                       **kw)
    y_tp, aux_tp = moe.moe_tp_shardmap(xt, p, cfg, mesh, data_axes=("data",))
    # moe_apply on a mesh whose model axis divides E and S: the EP path
    applied, _ = moe.moe_apply(xt, p, cfg, mesh)
    default, _ = moe.moe_ep_shardmap(xt, p, cfg, mesh, data_axes=("data",))
    return {"y_ep": y_ep.float().numpy(), "aux_ep": float(aux_ep),
            "y_tp": y_tp.float().numpy(), "aux_tp": float(aux_tp),
            "ep_bits": y_ep.view(torch.int16 if dt == torch.bfloat16
                                 else torch.int32).numpy(),
            "applied_is_ep": torch.equal(applied, default)}


def compress_job(grads, errs, p):
    """``compressed_psum`` on the first p ranks of the world (one PE
    each, on the CPU): this rank's row of each (p, …) gradient and
    residual in ``grads``/``errs`` (dicts of numpy arrays), and back its
    mean gradients and new residuals (None on the ranks past p, which
    only join the making of the group)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.optim import compressed_psum
    group = dist.new_group(list(range(p)))
    rank = dist.get_rank()
    if rank >= p:
        return None
    with comm.distributed(group):
        g = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in grads.items()}
        e = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in errs.items()}
        out, err = compressed_psum(g, e, "data", p)
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in err.items()})


# ---------------------------------------------------------------------------
# Serving on a (data, model) mesh (run in the ranks)
# ---------------------------------------------------------------------------


def model_mesh(layout=(2, 4)):
    """The (data, model) ``DeviceMesh`` of the first d·m ranks (made on
    every rank: making it is collective)."""
    from repro_torch.dist.sharding import make_mesh
    d, m = layout
    return make_mesh(np.arange(d * m).reshape(d, m), ("data", "model"))


def smoke_cfg(arch, dtype, **kw):
    import dataclasses
    from repro_torch.configs import get_config, smoke_variant
    return dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype,
                               **kw)


def _f32(t):
    return t.float().numpy()


def mesh_decode_job(arch, tree, tokens, steps, cache_len):
    """Greedy float32 decode on the (2, 4) mesh from the reference's
    weights ``tree``, each rank holding its slices and its slice of a
    float32 decode state: (this rank's rows as (start, stop), every step's
    logits of those rows and the whole batch's tokens, gathered over
    ``data``)."""
    import torch
    from repro_torch.dist.sharding import gather_rows, local_rows
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    cfg = smoke_cfg(arch, "float32")
    mesh = model_mesh()
    model = params_from_jax(cfg, tree, device="cpu", mesh=mesh)
    B = tokens.shape[0]
    st = T.init_decode_state(cfg, B, cache_len, torch.float32, device="cpu",
                             mesh=mesh)
    tok = torch.from_numpy(tokens).long()
    out = []
    with torch.inference_mode():
        for _ in range(steps):
            logits, st = T.decode_step(model, st, {"tokens": tok}, cfg, mesh,
                                       ("data",))
            tok = gather_rows(logits[:, -1].argmax(-1), mesh, B)[:, None]
            out.append((_f32(logits), tok[:, 0].numpy()))
    rows = local_rows(B, mesh)
    return (rows.start, rows.stop), out


def mesh_forced_decode_job(arch, tree, feeds, cache_len, layout):
    """Teacher-forced float32 decode on the ``layout`` mesh from the
    reference's weights ``tree``, one step for each input of ``feeds``
    (numpy dicts of the whole batch's tokens or embeddings): this rank's
    rows, every step's logits of them, and each KV cache's (shape of k,
    shape of v, split): zamba2's shared caches, the layers' elsewhere."""
    import torch
    from repro_torch.dist.sharding import local_rows
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    cfg = smoke_cfg(arch, "float32")
    mesh = model_mesh(layout)
    model = params_from_jax(cfg, tree, device="cpu", mesh=mesh)
    B = next(iter(feeds[0].values())).shape[0]
    st = T.init_decode_state(cfg, B, cache_len, torch.float32, device="cpu",
                             mesh=mesh)
    out = []
    with torch.inference_mode():
        for feed in feeds:
            inp = {k: torch.from_numpy(v) for k, v in feed.items()}
            logits, st = T.decode_step(model, st, inp, cfg, mesh, ("data",))
            out.append(_f32(logits))
    kv = st.shared_caches if cfg.family == "hybrid" else st.caches
    caches = [(tuple(c.k.shape), tuple(c.v.shape), c.split) for c in kv]
    rows = local_rows(B, mesh)
    return (rows.start, rows.stop), out, caches


def mesh_prefill_job(arch, cfg_kw, tree, tokens):
    """``forward`` on the (2, 4) mesh in float32 from the reference's
    weights (``cfg_kw`` on the smoke config, ``last_only`` as its
    ``prefill_last_only``), and the prefill step's tokens: (this rank's
    rows as (start, stop), the logits of its rows, aux, the tokens of its
    rows)."""
    import torch
    from repro_torch.dist.sharding import local_rows
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    cfg = smoke_cfg(arch, "float32", **cfg_kw)
    mesh = model_mesh()
    model = params_from_jax(cfg, tree, device="cpu", mesh=mesh)
    inp = {"tokens": torch.from_numpy(tokens).long()}
    with torch.inference_mode():
        logits, aux = T.forward(model, inp, cfg, mesh, ("data",),
                                last_only=cfg.prefill_last_only)
        nxt = steps.make_prefill_step(cfg, mesh)(model, inp)
    rows = local_rows(tokens.shape[0], mesh)
    return (rows.start, rows.stop), _f32(logits), float(aux), nxt.numpy()


def mesh_serve_job(arch, dtype, batch, tokens, cache_len):
    """``serve`` on the (2, 4) mesh: this rank's tokens, and the bytes and
    count of the weights it holds."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import resident_bytes
    held = {}
    init = T.init_params

    def keep(cfg, gen, device=None):
        held["model"] = init(cfg, gen, device=device)
        return held["model"]
    T.init_params = keep
    try:
        toks, stats = serve(smoke_cfg(arch, dtype), model_mesh(),
                            batch=batch, tokens=tokens, cache_len=cache_len,
                            logger=lambda s: None, device="cpu")
    finally:
        T.init_params = init
    return toks, stats["n"], resident_bytes(held["model"])


def serve_cli_job(argv):
    """The model-serving CLI on this rank: its tokens."""
    from repro_torch.launch.serve import main
    return main(argv)[0]


def resident_job(arch, dtype, tree):
    """The weights this rank holds after ``params_from_jax`` on the (2, 4)
    mesh, by the reference's path (a stacked leaf's layers stacked), as
    float32 numpy arrays."""
    import torch
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.tree import Stacked, param_tree
    model = params_from_jax(smoke_cfg(arch, dtype), tree, device="cpu",
                            mesh=model_mesh())
    return {"/".join(k): _f32(torch.stack(list(v)) if isinstance(v, Stacked)
                              else v) for k, v in param_tree(model).items()}


def mesh_errors_job():
    """The errors of a mesh that leaves ranks out: ``serve`` on it (every
    rank), and this rank's rows of it (the ranks outside)."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import local_rows
    from repro_torch.launch.serve import serve
    small = model_mesh((2, 2))
    out = {}
    try:
        serve(smoke_cfg("rwkv6-1.6b", "float32"), small, batch=2, tokens=1,
              device="cpu")
    except ValueError as e:
        out["serve"] = str(e)
    try:
        out["rows"] = local_rows(4, small)
    except ValueError as e:
        out["rows"] = str(e)
    out["rank"] = dist.get_rank()
    return out


# ---------------------------------------------------------------------------
# Training on a (data, model) mesh (run in the ranks)
# ---------------------------------------------------------------------------


def _host(leaf):
    """A leaf (tensor, ``Stacked`` or number) as a numpy array, block
    leaves stacked as (L, …), float32 for floats."""
    import torch
    from repro_torch.optim.tree import Stacked
    if isinstance(leaf, int):
        return np.asarray(leaf)
    t = torch.stack(list(leaf)) if isinstance(leaf, Stacked) else leaf
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).numpy().copy()


def _whole_host(tree, shardings):
    """Every leaf of ``tree`` (this rank's slices) put together whole, as
    numpy arrays in flatten order (collective)."""
    from repro_torch.optim import tree as tr
    return [_host(sh.whole(leaf)) for leaf, sh in
            zip(tr.leaves(tree), tr.leaves(shardings))]


def _torch_batch(batch):
    import torch
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in
            batch.items()}


def mesh_grad_job(arch, cfg_kw, tree, batch):
    """The loss and gradients of the float32 smoke config of ``arch``
    (``cfg_kw`` replaced) on the (2, 4) mesh from the reference's weights
    ``tree``: (loss, gradient leaves put together whole, by the
    reference's paths)."""
    from repro_torch.launch import steps as S
    from repro_torch.models.convert import params_from_jax
    cfg = smoke_cfg(arch, "float32", **cfg_kw)
    mesh = model_mesh()
    model = params_from_jax(cfg, tree, device="cpu",
                            mesh=mesh).requires_grad_(True)
    shards = S.state_shardings(cfg, mesh).params
    loss, grads = S.loss_and_grads(model, _torch_batch(batch), cfg, mesh,
                                   ("data",))
    whole = dict(zip(grads, _whole_host(grads, {k: shards[k]
                                                 for k in grads})))
    return float(loss), {"/".join(k): v for k, v in whole.items()}


def mesh_loss_job(arch, cfg_kw, tree, batch):
    """``forward`` and ``loss_fn`` of the float32 smoke config of ``arch``
    (``cfg_kw`` replaced) on the (2, 4) mesh from the reference's weights
    ``tree``: this rank's rows as (start, stop), the logits it returns,
    and the loss (as a float and as its float32 bits)."""
    import torch
    from repro_torch.dist.sharding import local_rows
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    cfg = smoke_cfg(arch, "float32", **cfg_kw)
    mesh = model_mesh()
    model = params_from_jax(cfg, tree, device="cpu", mesh=mesh)
    b = _torch_batch(batch)
    with torch.no_grad():
        logits, _ = T.forward(model, b, cfg, mesh, ("data",))
        loss = T.loss_fn(model, b, cfg, mesh, ("data",))
    B = b["labels"].shape[0]
    rows = local_rows(B, mesh, T.row_axes(mesh, cfg, B))
    return ((rows.start, rows.stop), _f32(logits), float(loss),
            int(loss.reshape(1).view(torch.int32)))


def mesh_ce_job(logits, labels, split):
    """The mean token loss (z-loss included) of float32 ``logits`` (B, S,
    V) against ``labels`` on the (2, 4) mesh, each rank holding its rows
    and, with ``split``, its slice of the vocabulary (the loss reckoned
    over the slices), else every word; and the gradient of the logits it
    holds, each rank backpropagating one over ``model`` of the loss, as
    ``loss_and_grads`` does: (its rows, its words, the loss, its float32
    bits, the gradient)."""
    import torch
    from repro_torch.dist.sharding import (local_rows, mesh_coord,
                                           mesh_sizes, sum_over)
    from repro_torch.models.layers import cross_entropy_sum
    mesh = model_mesh()
    B, _, V = logits.shape
    rows = local_rows(B, mesh)
    m = mesh_sizes(mesh)["model"]
    words = slice(0, V)
    if split:
        words = slice(mesh_coord(mesh)["model"] * (V // m),
                      (mesh_coord(mesh)["model"] + 1) * (V // m))
    x = torch.from_numpy(logits[rows, :, words]).requires_grad_(True)
    part = cross_entropy_sum(
        x, torch.from_numpy(labels[rows]).long(), mesh=mesh,
        vocab_lo=words.start if split else None) / labels.size
    loss = sum_over(part, mesh, ("data",))
    loss.backward(torch.full_like(loss, 1.0 / m))
    return ((rows.start, rows.stop), (words.start, words.stop),
            float(loss), int(loss.detach().reshape(1).view(torch.int32)),
            x.grad.numpy())


def mesh_rest_vs_whole_job(arch, tree, feed):
    """The float32 smoke config of ``arch`` on the (2, 4) mesh from the
    reference's weights ``tree``, sharded at rest and whole, on ``feed``
    (numpy: the whole batch's tokens or frame embeddings, and labels for
    audio): ``forward``'s logits, ``loss_fn`` and two decode steps' logits
    of each, as numpy arrays: (this rank's rows, at rest, whole)."""
    import torch
    from repro_torch.dist.sharding import local_rows
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    cfg = smoke_cfg(arch, "float32")
    mesh = model_mesh()
    key = "embeds" if "embeds" in feed else "tokens"
    x = torch.from_numpy(feed[key])
    x = x.long() if key == "tokens" else x
    labels = torch.from_numpy(feed["labels"]).long() if "labels" in feed \
        else torch.roll(x, 1, dims=1)
    B = x.shape[0]
    out = []
    for at_rest in (mesh, None):
        model = params_from_jax(cfg, tree, device="cpu", mesh=at_rest)
        got = []
        with torch.no_grad():
            got.append(_f32(T.forward(model, {key: x}, cfg, mesh,
                                      ("data",))[0]))
            got.append(_f32(T.loss_fn(model, {key: x, "labels": labels},
                                      cfg, mesh, ("data",))))
            st = T.init_decode_state(cfg, B, 4, torch.float32, device="cpu",
                                     mesh=mesh)
            for t in range(2):
                lg, st = T.decode_step(model, st, {key: x[:, t:t + 1]}, cfg,
                                       mesh, ("data",))
                got.append(_f32(lg))
        out.append(got)
    rows = local_rows(B, mesh)
    return (rows.start, rows.stop), out[0], out[1]


def mesh_step_job(arch, state_tree, batch, step_kw, ckpt_dir=None):
    """One ``make_train_step`` on the (2, 4) mesh from the reference's
    float32 ``TrainState`` (leaves as numpy): this rank's slices of every
    leaf of the new state, in flatten order, and the metrics; with
    ``ckpt_dir``, the new state saved there from the mesh, and its leaves
    put together whole."""
    from repro_torch.launch import steps as S
    from repro_torch.models.convert import (train_state_from_jax,
                                            train_state_leaves)
    from repro_torch.runtime import CheckpointManager
    cfg = smoke_cfg(arch, "float32")
    mesh = model_mesh()
    state = train_state_from_jax(cfg, state_tree, device="cpu", mesh=mesh)
    step, _ = S.make_train_step(cfg, mesh, **step_kw)
    state, metrics = step(state, batch)
    out = {"slices": train_state_leaves(state),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "kinds": {k: (tuple(v.shape), str(v.dtype))
                     for k, v in metrics.items()}}
    if ckpt_dir is not None:             # the new state, saved and whole
        shards = S.state_shardings(cfg, mesh)
        mgr = CheckpointManager(ckpt_dir, mesh=mesh)
        mgr.save(state.step, state, shardings=shards)
        out["latest"] = mgr.latest_step()
        out["whole"] = _whole_host(state, shards)
    return out


def mesh_restore_job(arch, ckpt_dir, layout):
    """``rescale_state`` of the checkpoint in ``ckpt_dir`` onto the
    ``layout`` mesh of the ranks, into a state drawn from another seed:
    this rank's slices of every leaf, in flatten order."""
    from repro_torch.launch import train as TR
    from repro_torch.models.convert import train_state_leaves
    from repro_torch.runtime import CheckpointManager, rescale_state
    cfg = smoke_cfg(arch, "float32")
    mesh = model_mesh(layout)
    like = TR.build_everything(cfg, mesh, 4, 16, seed=1, device="cpu")[0]
    out = rescale_state(None, like, cfg, mesh, CheckpointManager(ckpt_dir))
    assert out.params is like.params
    return train_state_leaves(out)


def _from_tree(tree):
    """``init_params`` replaced by the reference's weights ``tree``."""
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax

    def init(cfg, gen, device=None):
        return params_from_jax(cfg, tree, device=device)
    return T, init


def mesh_train_job(arch, tree, kw, ckpt_dir):
    """``train`` of the float32 smoke config of ``arch`` on the (2, 4) mesh
    from the reference's weights ``tree`` (``init_params`` replaced),
    with ``kw``: (losses, log lines, and on rank 0 the checkpoint
    directory's entries)."""
    import os
    import torch.distributed as dist
    from repro_torch.launch import train as TR
    cfg = smoke_cfg(arch, "float32")
    T, init = _from_tree(tree)
    saved = T.init_params
    T.init_params = init
    lines = []
    try:
        _, losses = TR.train(cfg, model_mesh(), ckpt_dir=ckpt_dir,
                             log_every=1, logger=lines.append, device="cpu",
                             **kw)
    finally:
        T.init_params = saved
    listing = sorted(os.listdir(ckpt_dir)) if dist.get_rank() == 0 else None
    return losses, lines, listing


def train_cli_job(argv, arch, kw):
    """``train --mesh 2,4`` (``argv``) on this rank, and ``train`` of the
    smoke config of ``arch`` on the (2, 4) mesh with ``kw``: both runs'
    losses."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.launch import train as TR
    _, cli = TR.main(argv)
    _, fn = TR.train(smoke_variant(get_config(arch)), model_mesh(),
                     device="cpu", logger=lambda s: None, **kw)
    return cli, fn


def mesh_train_errors_job():
    """The errors of a mesh that is not the group's size: ``train`` on a
    (2, 2) mesh of the eight ranks, and ``train --mesh 2,2``."""
    from repro_torch.launch import train as TR
    out = {}
    try:
        TR.train(smoke_cfg("llama3.2-1b", "float32"), model_mesh((2, 2)),
                 steps=1, batch=2, seq=8, device="cpu")
    except ValueError as e:
        out["train"] = str(e)
    try:
        TR.main(["--smoke", "--steps", "1", "--mesh", "2,2", "--device",
                 "cpu"])
    except ValueError as e:
        out["cli"] = str(e)
    return out


# ---------------------------------------------------------------------------
# The MoE layer on a (data, model) mesh (run in the ranks)
# ---------------------------------------------------------------------------


def _greedy(model, st, tok, cfg, mesh, steps):
    """``steps`` greedy decode steps from ``tok`` (the whole batch): each
    step's logits of this rank's rows and the whole batch's tokens, the
    bytes this rank's transport carried in the first step's
    ``decode_step`` (sent, received), and the last state."""
    import torch
    from repro_torch.core import comm
    from repro_torch.dist.sharding import gather_rows
    from repro_torch.models import transformer as T
    out, wire = [], None
    B = tok.shape[0]
    with torch.inference_mode():
        for _ in range(steps):
            with comm.count_wire() as w:
                logits, st = T.decode_step(model, st, {"tokens": tok}, cfg,
                                           mesh, ("data",))
            wire = wire or [w.sent, w.received]
            tok = gather_rows(logits[:, -1].argmax(-1), mesh, B)[:, None]
            out.append((_f32(logits), tok[:, 0].numpy()))
    return out, wire, st


def mesh_moe_job(arch, cfg_kw, tree, layout, tasks):
    """The float32 smoke config of ``arch`` (``cfg_kw`` replaced) on the
    ``layout`` mesh of the first d·m ranks (None on the others, which
    only join the making of the mesh), sharded at rest from the
    reference's weights ``tree``; for each ``(kind, feed)`` of ``tasks``:

    - ``"prefill"``: this rank's rows as (start, stop), ``forward``'s
      logits of them and aux;
    - ``"train"``: ``loss_and_grads``' loss and gradient leaves put
      together whole, the shapes of the weights its blocks gathered whole
      (``gather_model``), then one ``make_train_step`` step: the bytes
      this rank sent and received, beside ``launch.dryrun.reckon``'s for
      its ``MeshLayout``;
    - ``"decode"``: greedy decode from ``feed["tokens"]`` over a float32
      state of ``feed["cache_len"]`` slots for ``feed["steps"]`` steps
      (this rank's rows, the logits of its rows and the tokens), the
      bytes of its first step beside the dry-run's;
    - ``"serve"``: ``serve``'s steps in bfloat16 from ``feed["tokens"]``
      (the whole batch's tokens of each step).

    Returns the results in the order of ``tasks``."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.dist.sharding import MeshLayout, gather_rows, local_rows
    from repro_torch.launch import dryrun, steps as S
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    cfg = smoke_cfg(arch, "float32", **cfg_kw)
    mesh = model_mesh(layout)
    if dist.get_rank() >= layout[0] * layout[1]:
        return None
    here = MeshLayout.of_rank(("data", "model"), layout, dist.get_rank())

    def reckoned(kind, seq, batch, **kw):
        rec = dryrun.reckon(cfg, ShapeConfig(kind, seq, batch, kind), here,
                            **kw)
        return [rec["sent_bytes_per_device"],
                rec["received_bytes_per_device"]]

    out = []
    for kind, feed in tasks:
        model = params_from_jax(cfg, tree, device="cpu", mesh=mesh)
        if kind == "prefill":
            tok = torch.from_numpy(feed["tokens"]).long()
            with torch.inference_mode():
                logits, aux = T.forward(model, {"tokens": tok}, cfg, mesh,
                                        ("data",))
            rows = local_rows(tok.shape[0], mesh, T.row_axes(
                mesh, cfg, tok.shape[0]))
            out.append(((rows.start, rows.stop), _f32(logits), float(aux)))
        elif kind == "train":
            model.requires_grad_(True)
            shards = S.state_shardings(cfg, mesh)
            gathered, real = [], T.gather_model

            def spy(ts, *a, **k):
                gathered.extend(tuple(t.shape) for t in ts)
                return real(ts, *a, **k)
            T.gather_model = spy
            try:
                loss, grads = S.loss_and_grads(
                    model, _torch_batch(feed), cfg, mesh, ("data",))
            finally:
                T.gather_model = real
            whole = dict(zip(grads, _whole_host(grads, {
                k: shards.params[k] for k in grads})))
            step, opt_init = S.make_train_step(cfg, mesh)
            state = S.TrainState(model, opt_init(model), 0)
            B, Sq = feed["tokens"].shape
            with comm.count_wire() as w:
                step(state, feed)
            out.append((float(loss),
                        {"/".join(k): v for k, v in whole.items()},
                        sorted(set(gathered)), [w.sent, w.received],
                        reckoned("train", Sq, B)))
        elif kind == "decode":
            tok = torch.from_numpy(feed["tokens"]).long()
            B = tok.shape[0]
            st = T.init_decode_state(cfg, B, feed["cache_len"],
                                     torch.float32, device="cpu", mesh=mesh)
            steps, wire, _ = _greedy(model, st, tok, cfg, mesh,
                                     feed["steps"])
            rows = local_rows(B, mesh)
            out.append(((rows.start, rows.stop), steps, wire,
                        reckoned("decode", feed["cache_len"], B,
                                 cache_dtype=torch.float32)))
        elif kind == "serve":
            # ``serve``'s steps: ``make_serve_step`` on bf16 weights and
            # caches (``serve`` itself takes a mesh of the whole group)
            bf = dataclasses.replace(cfg, dtype="bfloat16")
            model = params_from_jax(bf, tree, device="cpu", mesh=mesh)
            B = feed["tokens"].shape[0]
            st = T.init_decode_state(bf, B, feed["cache_len"],
                                     torch.bfloat16, device="cpu", mesh=mesh)
            step = S.make_serve_step(bf, mesh)
            tok = torch.from_numpy(feed["tokens"]).to(torch.int32)
            toks = []
            with torch.inference_mode():
                for _ in range(feed["steps"]):
                    nxt, st = step(model, st, {"tokens": tok})
                    tok = gather_rows(nxt, mesh, B)[:, None]
                    toks.append(tok[:, 0].numpy())
            out.append(np.stack(toks))
    return out


# ---------------------------------------------------------------------------
# rwkv6 and mamba2 on a (data, model) mesh (run in the ranks)
# ---------------------------------------------------------------------------


def mesh_ssm_job(arch, tree, layout, prefill, decode):
    """The float32 smoke config of ``arch`` (rwkv6, zamba2) on the
    ``layout`` mesh of the first d·m ranks (None on the others, which
    only join the making of the mesh), sharded at rest from the
    reference's weights ``tree``:

    - ``"prefill"``: this rank's rows as (start, stop), ``forward``'s
      logits of them on ``prefill["tokens"]``, the shapes of the weights
      it gathered whole (``gather_model``), and the bytes the prefill
      step sent and received beside ``launch.dryrun.reckon``'s for the
      rank's ``MeshLayout``;
    - ``"decode"``: greedy decode from ``decode["tokens"]`` over a
      float32 state of ``decode["cache_len"]`` slots for
      ``decode["steps"]`` steps: each step's logits of the rank's rows
      and the tokens, each layer's recurrent state as the rank holds it
      after the last step, the shapes gathered, and the first step's
      bytes beside the dry-run's."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.core import comm
    from repro_torch.dist.sharding import MeshLayout, local_rows
    from repro_torch.launch import dryrun, steps as S
    from repro_torch.models import transformer as T
    from repro_torch.models.convert import params_from_jax
    cfg = smoke_cfg(arch, "float32")
    mesh = model_mesh(layout)
    if dist.get_rank() >= layout[0] * layout[1]:
        return None
    here = MeshLayout.of_rank(("data", "model"), layout, dist.get_rank())

    def reckoned(kind, seq, batch):
        rec = dryrun.reckon(cfg, ShapeConfig(kind, seq, batch, kind), here,
                            cache_dtype=torch.float32)
        return [rec["sent_bytes_per_device"],
                rec["received_bytes_per_device"]]

    model = params_from_jax(cfg, tree, device="cpu", mesh=mesh)
    gathered, real = [], T.gather_model

    def spy(ts, *a, **k):
        gathered.extend(tuple(t.shape) for t in ts)
        return real(ts, *a, **k)
    out = {}
    T.gather_model = spy
    try:
        tok = torch.from_numpy(prefill["tokens"]).long()
        B, Sq = tok.shape
        with torch.inference_mode():
            logits, _ = T.forward(model, {"tokens": tok}, cfg, mesh,
                                  ("data",))
            with comm.count_wire() as w:
                S.make_prefill_step(cfg, mesh)(model, {"tokens": tok})
        rows = local_rows(B, mesh)
        out["prefill"] = ((rows.start, rows.stop), _f32(logits),
                          sorted(set(gathered)), [w.sent, w.received],
                          reckoned("prefill", Sq, B))
        gathered.clear()
        tok = torch.from_numpy(decode["tokens"]).long()
        B = tok.shape[0]
        st = T.init_decode_state(cfg, B, decode["cache_len"], torch.float32,
                                 device="cpu", mesh=mesh)
        steps, wire, st = _greedy(model, st, tok, cfg, mesh,
                                  decode["steps"])
    finally:
        T.gather_model = real
    states = [{f: _f32(getattr(c, f)) for f in c._fields} for c in st.caches]
    out["decode"] = (steps, states, sorted(set(gathered)), wire,
                     reckoned("decode", decode["cache_len"], B))
    return out
