"""The port's int8 compressed gradient mean (``repro_torch.optim.
grad_compress``) against the reference's on the CPU: each PE's int8
payload and scale equal to the compiled reference's, the sim backend of
each package on the same per-PE gradients (equal bit for bit where XLA
compiles the sum of the sources as one chain, as at p = 8; within two
float32 ulps of the largest value summed or subtracted where it
compiles a tree or drops a fused multiply-add), the reference's error-feedback convergence on a
quadratic, the wire bytes of the collective trace, and eight and four
gloo ranks (``comm.distributed``, one PE per rank) equal to the port's
sim bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (jax_enable_x64, as in the other tests)
from repro.core import comm as jc
from repro.optim import grad_compress as JG
from repro_torch.core import comm
from repro_torch.optim import grad_compress as G
from torch_dist_helpers import RankPool, compress_job


def _grads(p, shape, seed, scale=1.0):
    r = np.random.default_rng(seed)
    return (scale * r.normal(size=(p,) + shape)).astype(np.float32)


def _ref_mean(data, err, p):
    def body(g, e):
        return JG.compressed_psum_mean(g, e, "data", p)
    out, new = jax.jit(jc.sim_map(body, "data", p))(jnp.asarray(data),
                                                     jnp.asarray(err))
    return np.asarray(out), np.asarray(new)


@pytest.mark.parametrize("shape", [(8, 8), (33,), (5, 7, 3), (8, 125)])
def test_quant_payloads_and_scales_equal(shape):
    """Each PE's int8 chunks and scale, from its row alone, as the
    reference's compiled ``_quant`` gives them."""
    x = _grads(8, shape, 1, scale=3.0)
    q, s = G._quant(torch.from_numpy(x))
    quant = jax.jit(JG._quant)
    for i in range(x.shape[0]):
        qj, sj = quant(jnp.asarray(x[i]))
        np.testing.assert_array_equal(q[i].numpy(), np.asarray(qj))
        assert q.dtype == torch.int8 and np.asarray(qj).dtype == np.int8
        np.testing.assert_array_equal(s[i].numpy(), np.asarray(sj))


def test_rounding_is_half_to_even():
    """Ties go to the even integer in both packages (the int8 payload of
    a row whose scale is 1 holds its values rounded)."""
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], np.float32)
    q, s = G._quant(torch.from_numpy(x))
    qj, sj = jax.jit(JG._quant)(jnp.asarray(x[0]))
    assert float(s[0]) == float(sj) == float(np.float32(1.0) + 1e-12)
    assert q[0].tolist() == np.asarray(qj).tolist() == [0, 2, 2, 0, -2, 127]


@pytest.mark.parametrize("p,shape,exact", [
    (8, (24,), True), (8, (5, 13), True), (8, (1000,), True),
    (64, (33,), False), (16, (77,), False), (4, (3, 4, 5), False)])
def test_sim_matches_reference_sim(p, shape, exact):
    data = _grads(p, shape, 3)
    err = _grads(p, shape, 4, scale=1e-3)
    want, want_err = _ref_mean(data, err, p)
    got, got_err = G.compressed_psum_mean(torch.from_numpy(data),
                                          torch.from_numpy(err), "data", p)
    assert got.shape == got_err.shape == data.shape
    # the mean's ulps are those of its values, the residual's those of
    # the values it is the difference of (gradient + old residual)
    for mine, ref, scale in ((got.numpy(), want, want),
                             (got_err.numpy(), want_err, data + err)):
        if exact:
            np.testing.assert_array_equal(mine, ref)
        else:
            ulps = 2 * np.spacing(np.abs(scale).max())
            np.testing.assert_allclose(mine, ref, rtol=0, atol=ulps)
    # two int8 quantization rounds: error bounded by ~2 quantization steps
    exact = data.mean(axis=0)
    tol = 2.5 * (np.abs(data + err).max() / 127 + np.abs(exact).max() / 127)
    assert np.abs(got.numpy() - exact[None]).max() < tol


def test_tree_and_init_error_feedback():
    p = 8
    grads = {"a": torch.from_numpy(_grads(p, (6, 4), 5)),
             "b": torch.from_numpy(_grads(p, (9,), 6))}
    err = G.init_error_feedback(grads)
    assert all(e.dtype == torch.float32 and torch.count_nonzero(e) == 0
               and e.shape == grads[k].shape for k, e in err.items())
    out, new = G.compressed_psum(grads, err, "data", p)
    for k in grads:
        o, n = G.compressed_psum_mean(grads[k], err[k], "data", p)
        assert torch.equal(out[k], o) and torch.equal(new[k], n)


def test_error_feedback_converges_on_a_quadratic():
    """SGD on a quadratic with the compressed mean converges to the same
    optimum as exact gradients (the reference's test, on the sim)."""
    p = 4
    r = np.random.default_rng(0)
    target = r.normal(size=(32,)).astype(np.float32)
    data = torch.from_numpy((target[None] + 0.1 * r.normal(size=(p, 32)))
                            .astype(np.float32))
    w = torch.zeros(32)
    err = torch.zeros(p, 32)
    for _ in range(200):
        g, err = G.compressed_psum_mean(2 * (w[None] - data), err, "data", p)
        assert torch.equal(g, g[:1].expand_as(g))     # every PE agrees
        w = w - 0.05 * g[0]
    assert float((w - data.mean(0)).abs().max()) < 2e-2


def test_wire_bytes_are_a_quarter_of_float32():
    """The trace of the compressed mean moves under 0.45× the bytes of a
    float32 psum of the same gradient."""
    p, n = 4, 1 << 16
    g = torch.zeros(p, n)
    with comm.counting() as trace:
        G.compressed_psum_mean(g, torch.zeros(p, n), "data", p)
    with comm.counting() as exact:
        comm.psum(g)
    assert trace.counts() == {"all_to_all": 1, "all_gather": 3}
    assert trace.wire_bytes() < 0.45 * exact.wire_bytes()


@pytest.fixture(scope="module")
def pool():
    p = RankPool(world=8)
    yield p
    p.close()


@pytest.mark.parametrize("p", [8, 4])
def test_gloo_ranks_equal_sim_bit_for_bit(pool, p):
    grads = {"w": _grads(p, (40, 6), 7), "b": _grads(p, (13,), 8)}
    errs = {k: _grads(p, v.shape[1:], 9, 1e-3) for k, v in grads.items()}
    sim, sim_err = G.compressed_psum(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in errs.items()}, "data", p)
    answers = pool.run(compress_job, grads, errs, p)
    assert all(a is None for a in answers[p:])
    for rank, (out, err) in enumerate(answers[:p]):
        for k in grads:
            np.testing.assert_array_equal(out[k], sim[k][rank:rank + 1])
            np.testing.assert_array_equal(err[k], sim_err[k][rank:rank + 1])
