"""The port's MoE dispatch (``repro_torch.models.moe``) and the slotted
exchange's trailing-dimension payloads against the reference on the CPU.

Integer results are exact: router ids (ties to the lower expert, as
``jax.lax.top_k``), ``_group_by_expert``'s slots and kept flags, the
route's keys, payloads, counts and overflow, and the dispatch's drops.
Floats: ``tests/torch_model_helpers.py`` (float32 within ``F32``; bf16 no
further from the float32 run than the reference's bf16 run is).  The
distributed dispatch runs on four gloo ranks (a (data 2, model 2) mesh)
and must equal the port's emulated dispatch bit for bit, as the
reference's ``moe_ep_shardmap`` equals its ``moe_ep_sim``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.core import comm as jc
from repro.core import hypercube as jhc
from repro.core import types as jt
from repro.models import moe as JM
from repro_torch.core import hypercube as thc
from repro_torch.core import types as tt
from repro_torch.models import moe as M
from torch_dist_helpers import RankPool, moe_job
from torch_helpers import AXIS, run_sim
from torch_model_helpers import (F32, assert_bf16, assert_f32, configs, f32,
                                 npt, tensors, upcast)

ARCH = "granite-moe-1b-a400m"        # smoke: E = 4, top-2, d 64, f 128


def _setup(dtype="float32", seed=0, B=2, S=32):
    jcfg, tcfg = configs(ARCH, dtype)
    p = JM.init_moe(jax.random.PRNGKey(seed), jcfg.d_model, jcfg.d_ff,
                    jcfg.n_experts, jnp.dtype(dtype))
    x = np.random.default_rng(seed).normal(
        size=(B, S, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jcfg, tcfg, p, jx, tensors(npt(p)), torch.from_numpy(f32(jx)).to(
        getattr(torch, dtype))


def _skewed(p, jcfg):
    """Everything routes to expert 0; experts 1 … E-1 tie exactly."""
    router = np.zeros((jcfg.d_model, jcfg.n_experts), np.float32)
    router[:, 0] = 10.0
    return dict(p, router=jnp.asarray(router))


# --- router and grouping -----------------------------------------------------


@pytest.mark.parametrize("skew", [False, True])
def test_router(skew):
    jcfg, tcfg, p, jx, tp, tx = _setup()
    if skew:
        p = _skewed(p, jcfg)
        tp = tensors(npt(p))
    jw, ji, ja = JM._router(jx, p["router"], jcfg.top_k)
    tw, ti, ta = M._router(tx, tp.router, tcfg.top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_f32(tw, jw)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


def test_router_ties_go_to_the_lower_expert():
    """31 equal probabilities (granite's 32 experts, the skewed router):
    the picks after expert 0 are experts 1, 2, … in order, as
    ``jax.lax.top_k`` gives them."""
    w = np.zeros((8, 32), np.float32)
    w[:, 0] = 10.0
    x = np.abs(np.random.default_rng(1).normal(size=(5, 8))).astype(
        np.float32)
    _, ji, _ = JM._router(jnp.asarray(x), jnp.asarray(w), 8)
    _, ti, _ = M._router(torch.from_numpy(x), torch.from_numpy(w), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), np.tile(np.arange(8), (5, 1)))


@pytest.mark.parametrize("E,cap", [(4, 2), (4, 5), (8, 1), (3, 100)])
def test_group_by_expert_exact(E, cap):
    eids = np.random.default_rng(E * cap).integers(0, E + 1, size=64)
    js, jk = JM._group_by_expert(jnp.asarray(eids, jnp.int32), E, cap)
    ts, tk = M._group_by_expert(torch.from_numpy(eids), E, cap)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_group_by_expert_capacity():
    """The reference's own case, and batched rows as ``moe_local`` takes
    them (each row grouped alone)."""
    eids = torch.tensor([0, 0, 0, 1, 0, 2, 0])
    slot, kept = M._group_by_expert(eids, 4, capacity=2)
    assert slot[:3].tolist() == [0, 1, 2]
    assert kept.tolist() == [True, True, False, True, False, True, False]
    rows = torch.stack([eids, eids.flip(0)])
    s2, k2 = M._group_by_expert(rows, 4, capacity=2)
    assert torch.equal(s2[0], slot) and torch.equal(k2[0], kept)
    assert torch.equal(s2[1], M._group_by_expert(eids.flip(0), 4, 2)[0])


def test_decode_grouping_keeps_every_item():
    """At S = 1 a token's k items go to k distinct experts, so the local
    capacity int(2·k/E) + 1 ≥ 1 keeps them all (where a forward at
    capacity factor 2 may drop): why only dense models match prefill to
    decode."""
    jcfg, tcfg, p, jx, tp, tx = _setup(B=8, S=1)
    _, ids, _ = M._router(tx, tp.router, tcfg.top_k)
    cap = int(2.0 * tcfg.top_k / tcfg.n_experts) + 1
    _, kept = M._group_by_expert(ids.reshape(8, -1), tcfg.n_experts, cap)
    assert bool(kept.all())


def test_expert_ffn():
    jcfg, tcfg, p, jx, tp, tx = _setup()
    buf = np.random.default_rng(3).normal(
        size=(jcfg.n_experts, 6, jcfg.d_model)).astype(np.float32)
    assert_f32(M._expert_ffn(torch.from_numpy(buf), tp.up, tp.gate, tp.down),
               JM._expert_ffn(jnp.asarray(buf), p["up"], p["gate"],
                              p["down"]))


# --- the layouts against the reference ---------------------------------------


def _layouts(jcfg, tcfg):
    """(reference call, port call) of every one-process layout, each on
    (x, weights); the reference's jitted."""
    f16 = dict(capacity_factor=16.0, slot_factor=16.0)
    pairs = [
        (lambda x, p: JM.moe_local(x, p, jcfg),
         lambda x, p: M.moe_local(x, p, tcfg)),
        (lambda x, p: JM.moe_local(x, p, jcfg, capacity_factor=8.0),
         lambda x, p: M.moe_local(x, p, tcfg, capacity_factor=8.0)),
        (lambda x, p: JM.moe_dense(x, p, jcfg),
         lambda x, p: M.moe_dense(x, p, tcfg)),
        (lambda x, p: JM.moe_ep_sim(x, p, jcfg, d=1, ep=2),
         lambda x, p: M.moe_ep_sim(x, p, tcfg, d=1, ep=2)),
        (lambda x, p: JM.moe_ep_sim(x, p, jcfg, d=2, ep=2),
         lambda x, p: M.moe_ep_sim(x, p, tcfg, d=2, ep=2)),
        (lambda x, p: JM.moe_ep_sim(x, p, jcfg, d=2, ep=4, **f16),
         lambda x, p: M.moe_ep_sim(x, p, tcfg, d=2, ep=4, **f16)),
        (lambda x, p: JM.moe_ep_sim(x, p, jcfg),
         lambda x, p: M.moe_ep_sim(x, p, tcfg)),
        (lambda x, p: JM.moe_apply(x, p, jcfg),
         lambda x, p: M.moe_apply(x, p, tcfg)),
        (lambda x, p: JM.moe_apply(x, p, jcfg, impl="dense"),
         lambda x, p: M.moe_apply(x, p, tcfg, impl="dense")),
    ]
    return [(jax.jit(ref), port) for ref, port in pairs]


N_LAYOUTS = 9


@pytest.mark.parametrize("which", range(N_LAYOUTS))
def test_layouts_float32(which):
    jcfg, tcfg, p, jx, tp, tx = _setup()
    ref, port = _layouts(jcfg, tcfg)[which]
    (jy, ja), (ty, ta) = ref(jx, p), port(tx, tp)
    assert ty.dtype == torch.float32
    assert_f32(ty, jy)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("which", range(N_LAYOUTS))
def test_layouts_bf16(which):
    jcfg, tcfg, p, jx, tp, tx = _setup("bfloat16")
    ref, port = _layouts(jcfg, tcfg)[which]
    truth, _ = _layouts(dataclasses.replace(jcfg, dtype="float32"),
                        tcfg)[which]
    (jy, _), (ty, _) = ref(jx, p), port(tx, tp)
    y32, _ = truth(jx.astype(jnp.float32), upcast(p))
    assert ty.dtype == torch.bfloat16
    assert_bf16(ty, jy, y32)


def test_no_drops_all_layouts_agree():
    """With capacity and slot factors 16 nothing drops: every layout
    computes the same y (the reference's own equivalence test)."""
    jcfg, tcfg, p, jx, tp, tx = _setup()
    f16 = dict(capacity_factor=16.0, slot_factor=16.0)
    dense, _ = M.moe_dense(tx, tp, tcfg)
    for y in (M.moe_local(tx, tp, tcfg, capacity_factor=16.0)[0],
              M.moe_ep_sim(tx, tp, tcfg, d=1, ep=2, **f16)[0],
              M.moe_ep_sim(tx, tp, tcfg, d=2, ep=4, **f16)[0]):
        np.testing.assert_allclose(y.numpy(), dense.numpy(), **F32)


def _ref_drops(jcfg, jx, p, d, ep, cf=2.0, sf=2.0):
    """The reference body's per-PE drop counts (its ``moe_ep_sim``
    discards them)."""
    B, S, D = jx.shape
    body = JM._ep_dispatch_body(jcfg, "expert", ep, cf, sf)
    xb = jnp.moveaxis(jx.reshape(d, B // d, ep, S // ep, D), 2, 1)
    e_per = jcfg.n_experts // ep

    def tile(w, split):
        w = w.reshape((ep, e_per) + w.shape[1:]) if split else \
            jnp.broadcast_to(w[None], (ep,) + w.shape)
        return jnp.broadcast_to(w[None], (d,) + w.shape)
    run = jax.jit(jc.sim_map(body, "expert", ep, mesh=(d, ep),
                             data_axis="data"))
    _, _, drops = run(xb, tile(p["router"], False), tile(p["up"], True),
                      tile(p["gate"], True), tile(p["down"], True))
    return np.asarray(drops).reshape(-1)


@pytest.mark.parametrize("d,ep", [(1, 2), (2, 2), (1, 4)])
def test_skewed_router_drops(d, ep):
    """Everything to expert 0 at the default factors: the same exchange
    drops per PE as the reference's body, y equal and finite, overflow as
    dropped items and not as corruption."""
    jcfg, tcfg, p, jx, tp, tx = _setup()
    p = _skewed(p, jcfg)
    tp = tensors(npt(p))
    y, aux, drops = M._ep_sim(tx, tp, tcfg, d, ep, 2.0, 2.0)
    np.testing.assert_array_equal(drops.numpy(), _ref_drops(jcfg, jx, p, d,
                                                            ep))
    assert bool(torch.isfinite(y).all())
    jy, _ = jax.jit(lambda x, w: JM.moe_ep_sim(x, w, jcfg, d=d, ep=ep))(jx, p)
    assert_f32(y, jy)
    # expert 0's buffer overflows: its items past the capacity are dropped
    full, _ = M.moe_dense(tx, tp, tcfg)
    assert not torch.allclose(y, full, **F32)


def test_ep_sim_is_deterministic():
    jcfg, tcfg, p, jx, tp, tx = _setup()
    a, _ = M.moe_ep_sim(tx, tp, tcfg, d=2, ep=2)
    b, _ = M.moe_ep_sim(tx, tp, tcfg, d=2, ep=2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("d,ep", [(3, 2), (1, 3), (2, 8)])
def test_ep_sim_rejects_indivisible_layout(d, ep):
    jcfg, tcfg, p, jx, tp, tx = _setup()
    with pytest.raises(ValueError, match="not divisible"):
        JM.moe_ep_sim(jx, p, jcfg, d=d, ep=ep)
    with pytest.raises(ValueError, match="not divisible"):
        M.moe_ep_sim(tx, tp, tcfg, d=d, ep=ep)


# --- the exchange with trailing payload dimensions ---------------------------


def _route_state(p, C, D, seed):
    g = np.random.default_rng(seed)
    count = g.integers(0, C + 1, size=p)
    count[:2] = [0, C]
    keys = g.integers(0, 50, size=(p, C)).astype(np.uint32)
    keys = np.where(np.arange(C)[None] < count[:, None], keys,
                    np.uint32(0xFFFFFFFF))
    feat = g.normal(size=(p, C, D)).astype(np.float32)
    idx = g.integers(0, 2 ** 31, size=(p, C)).astype(np.int32)
    dest = g.integers(0, p, size=(p, C)).astype(np.int32)
    dest = np.where(np.arange(C)[None] < count[:, None], dest, p)
    return keys, feat, idx, count.astype(np.int32), dest


def _port_route_shard(keys, feat, idx, count):
    return tt.SortShard(tt.key_to_int(torch.from_numpy(keys)),
                        {"feat": torch.from_numpy(feat),
                         "idx": torch.from_numpy(idx)},
                        torch.from_numpy(count).long())


@pytest.mark.parametrize("p,C,D,slot_cap", [(4, 24, 3, 4), (4, 24, 5, 12),
                                            (8, 16, 2, 1), (2, 8, 7, 8)])
def test_route_with_feature_payload(p, C, D, slot_cap):
    """``_alltoall_route`` of a shard with an (N, D) payload beside a flat
    one: keys, both payloads inside the counts, counts and overflow equal
    the reference's."""
    keys, feat, idx, count, dest = _route_state(p, C, D, p * C + D)

    def body(k, f, i, c, dst):
        sh = jt.SortShard(keys=k, vals={"feat": f, "idx": i}, count=c)
        out, ov = jhc._alltoall_route(sh, dst, AXIS, p, slot_cap)
        return out.keys, out.vals["feat"], out.vals["idx"], out.count, ov
    wk, wf, wi, wc, wov = run_sim(p, body, keys, feat, idx, count, dest)
    out, ov = thc._alltoall_route(_port_route_shard(keys, feat, idx, count),
                                  torch.from_numpy(dest).long(), p, slot_cap)
    gk, _, gc = tt.shard_to_numpy(out.replace(vals={}))
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(ov.numpy(), wov)
    np.testing.assert_array_equal(gk, wk)
    for i, c in enumerate(gc):
        np.testing.assert_array_equal(out.vals["feat"][i, :c].numpy(),
                                      wf[i, :c])
        np.testing.assert_array_equal(out.vals["idx"][i, :c].numpy(),
                                      wi[i, :c])


def test_flat_payload_route_unchanged():
    """A (P, C) payload takes the path it took before: the same as the
    feature payload's flat neighbour, and as the streamed route sorted."""
    keys, feat, idx, count, dest = _route_state(4, 24, 3, 7)
    dst = torch.from_numpy(dest).long()
    wide, wov = thc._alltoall_route(_port_route_shard(keys, feat, idx, count),
                                    dst, 4, 6)
    flat = _port_route_shard(keys, feat, idx, count)
    flat = flat.replace(vals={"idx": flat.vals["idx"]})
    out, ov = thc._alltoall_route(flat, dst, 4, 6)
    assert torch.equal(ov, wov) and torch.equal(out.keys, wide.keys)
    assert torch.equal(out.vals["idx"], wide.vals["idx"])
    st, sov = thc._alltoall_route(flat, dst, 4, 6, stream=True)
    bar = tt.local_sort(out)
    assert torch.equal(sov, ov) and torch.equal(st.keys, bar.keys)


@pytest.mark.parametrize("D", [1, 4])
def test_compact_with_feature_payload(D):
    keys, feat, idx, count, _ = _route_state(4, 16, D, 11 + D)
    keep = np.random.default_rng(D).random((4, 16)) < 0.5

    def body(k, f, i, c, m):
        sh = jt.compact(jt.SortShard(keys=k, vals={"feat": f, "idx": i},
                                     count=c), m)
        return sh.keys, sh.vals["feat"], sh.vals["idx"], sh.count
    wk, wf, wi, wc = run_sim(4, body, keys, feat, idx, count, keep)
    out = tt.compact(_port_route_shard(keys, feat, idx, count),
                     torch.from_numpy(keep))
    gk, gv, gc = tt.shard_to_numpy(out.replace(vals={"idx": out.vals["idx"]}))
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gk, wk)
    # compact reorders every slot: payloads equal in full
    np.testing.assert_array_equal(out.vals["feat"].numpy(), wf)
    np.testing.assert_array_equal(out.vals["idx"].numpy(), wi)


# --- the distributed dispatch on gloo ranks ----------------------------------


@pytest.fixture(scope="module")
def pool():
    p = RankPool(world=4)
    yield p
    p.close()


@pytest.mark.parametrize("dtype,kw", [
    ("float32", {}), ("bfloat16", {}),
    ("float32", {"capacity_factor": 16.0, "slot_factor": 16.0})])
def test_ep_shardmap_equals_ep_sim(pool, dtype, kw):
    """Four ranks on a (data 2, model 2) mesh: ``moe_ep_shardmap`` equals
    the port's ``moe_ep_sim(d=2, ep=2)`` bit for bit on every rank, and
    ``moe_tp_shardmap`` matches ``moe_local``."""
    jcfg, tcfg, p, jx, tp, tx = _setup(dtype, B=4, S=32)
    params = {k: f32(v) for k, v in p.items()}
    out = pool.run(moe_job, ARCH, dtype, f32(jx), params, (2, 2), kw)
    want, aux = M.moe_ep_sim(tx, tp, tcfg, d=2, ep=2, **kw)
    bits = want.view(torch.int16 if dtype == "bfloat16"
                     else torch.int32).numpy()
    local, _ = M.moe_local(tx, tp, tcfg)
    # aux: the mean over the model axis of data row 0 (its batch half)
    _, laux = M.moe_local(tx[:2], tp, tcfg)
    for r in out:
        np.testing.assert_array_equal(r["ep_bits"], bits)
        assert r["applied_is_ep"]
        assert np.isfinite(r["aux_ep"])
        if dtype == "float32":
            np.testing.assert_allclose(r["y_tp"], local.numpy(), **F32)
            np.testing.assert_allclose(r["aux_tp"], float(laux), rtol=1e-5)
        else:
            truth, _ = M.moe_local(tx.float(), tensors(npt(upcast(p))),
                                   dataclasses.replace(tcfg,
                                                       dtype="float32"))
            assert_bf16(torch.from_numpy(r["y_tp"]), local, truth)
