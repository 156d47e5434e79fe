"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``) on the CPU: AdamW and Adafactor on the same numpy
weights, gradients and learning rate for a few steps, on plain leaves
(factored and not) and on stacked leaves (a ``Stacked`` of per-layer
tensors against the reference's (L, …) array), with Adafactor's clipping
engaged or not and its weight decay set; ``cosine_schedule``; and
``make_optimizer``'s refusal.  AdamW and the schedule are equal to the
reference's bit for bit; Adafactor within float32 rtol 1e-6 (its means
and rsqrt round apart by an ulp or two).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (jax_enable_x64, as in the other tests)
from repro import optim as JO
from repro_torch import optim as O
from repro_torch.models.convert import as_tensor
from repro_torch.optim.tree import Stacked

RTOL = 1e-6
SHAPES = {"w": ((6, 5), "float32"), "b": ((7,), "float32"),
          "h": ((2, 3, 4), "bfloat16"), "blk_w": ((3, 4, 5), "float32"),
          "blk_n": ((3, 6), "float32"), "blk_e": ((2, 3, 4, 5), "bfloat16")}
STACKED = ("blk_w", "blk_n", "blk_e")      # layer-stacked leaves


def _arrays(seed, scale=1.0):
    r = np.random.default_rng(seed)
    return {k: (scale * r.normal(size=shape)).astype(np.float32)
            for k, (shape, _) in SHAPES.items()}


def _ref(arrays):
    return {k: jnp.asarray(a).astype(SHAPES[k][1]) for k, a in arrays.items()}


def _port(arrays):
    """The arrays as the port's tree: stacked leaves as ``Stacked``."""
    out = {}
    for k, a in arrays.items():
        t = as_tensor(np.asarray(_ref({k: a})[k]))
        out[k] = Stacked(t.clone().unbind(0)) if k in STACKED else t.clone()
    return out


def _np(leaf):
    if isinstance(leaf, Stacked):
        leaf = torch.stack(list(leaf))
    return leaf.float().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=RTOL, atol=0)


def _run(name, steps, grad_scale=1.0, lr=1e-2, **kw):
    init_j, upd_j = JO.make_optimizer(name)
    init_t, upd_t = O.make_optimizer(name)
    pj, pt = _ref(_arrays(0)), _port(_arrays(0))
    sj, st = init_j(pj), init_t(pt)
    for i in range(steps):
        g = _arrays(10 + i, grad_scale)
        pj, sj = upd_j(_ref(g), sj, pj, lr=jnp.float32(lr), **kw)
        pt, st = upd_t(_port(g), st, pt, lr=lr, **kw)
    return pj, sj, pt, st


@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw(weight_decay):
    pj, sj, pt, st = _run("adamw", 3, weight_decay=weight_decay)
    assert st.step == int(sj.step) == 3
    for k in SHAPES:
        assert pt[k].dtype == getattr(torch, SHAPES[k][1])
        for got, want in ((pt[k], pj[k]), (st.mu[k], sj.mu[k]),
                          (st.nu[k], sj.nu[k])):
            np.testing.assert_array_equal(_np(got),
                                          np.asarray(want, np.float32))


@pytest.mark.parametrize("clip,grad_scale,weight_decay", [
    (1.0, 1.0, 0.0),        # the update's RMS passes 1: clipping engaged
    (50.0, 1.0, 0.0),       # never clipped
    (1.0, 1e-3, 0.05),      # small gradients, weight decay set
])
def test_adafactor(clip, grad_scale, weight_decay):
    pj, sj, pt, st = _run("adafactor", 3, grad_scale, clip=clip,
                          weight_decay=weight_decay)
    assert st.step == int(sj.step) == 3
    for k in SHAPES:
        factored = len(SHAPES[k][0]) >= 2
        assert tuple(st.vr[k].shape) == sj.vr[k].shape
        assert tuple(st.vc[k].shape) == sj.vc[k].shape == (
            SHAPES[k][0][:-2] + SHAPES[k][0][-1:] if factored else (1,))
        _close(pt[k], pj[k])
        _close(st.vr[k], sj.vr[k])
        _close(st.vc[k], sj.vc[k])


def test_adafactor_clipping_is_engaged():
    """At clip 1.0 the first update's RMS passes the clip (so the
    clipped case above takes the clipped path), at 50.0 it does not."""
    g = _arrays(10)["w"]
    beta = 1.0 - 2.0 ** -0.8
    u = g / np.sqrt((1 - beta) * np.mean(g * g + 1e-30, axis=-1,
                                         keepdims=True))
    assert 1.0 < np.sqrt(np.mean(u * u)) < 50.0


@pytest.mark.parametrize("step,warmup,total", [
    (0, 200, 10000), (100, 200, 10000), (200, 200, 10000),
    (5000, 200, 10000), (10000, 200, 10000), (20000, 200, 10000),
    (0, 0, 100), (37, 0, 100), (150, 0, 100)])
def test_cosine_schedule(step, warmup, total):
    want = JO.cosine_schedule(jnp.asarray(step, jnp.int32), peak_lr=3e-4,
                              warmup=warmup, total=total)
    got = O.cosine_schedule(step, peak_lr=3e-4, warmup=warmup, total=total)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(want)
    got_t = O.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                              peak_lr=3e-4, warmup=warmup, total=total)
    assert float(got_t) == float(got)


def test_make_optimizer():
    assert O.make_optimizer("adamw") == (O.adamw_init, O.adamw_update)
    assert O.make_optimizer("adafactor") == (O.adafactor_init,
                                             O.adafactor_update)
    with pytest.raises(ValueError, match="sgd"):
        O.make_optimizer("sgd")


def test_updates_write_in_place():
    """The weights and moments are the same tensors after a step (no
    second copy of the optimizer state)."""
    for name in ("adamw", "adafactor"):
        init, upd = O.make_optimizer(name)
        p = _port(_arrays(0))
        s = init(p)
        before = {k: [t.data_ptr() for t in (v if isinstance(v, Stacked)
                                             else (v,))]
                  for k, v in p.items()}
        moments = [t.data_ptr() for leaf in s[0].values()
                   for t in (leaf if isinstance(leaf, Stacked) else (leaf,))]
        p2, s2 = upd(_port(_arrays(1)), s, p, lr=1e-2)
        assert p2 is p
        assert {k: [t.data_ptr() for t in (v if isinstance(v, Stacked)
                                           else (v,))]
                for k, v in p2.items()} == before
        assert [t.data_ptr() for leaf in s2[0].values()
                for t in (leaf if isinstance(leaf, Stacked)
                          else (leaf,))] == moments
