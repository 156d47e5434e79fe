"""The port's data layer (``repro_torch.data.pipeline``) against the
reference's (``repro.data.pipeline``) on the CPU: ``TokenPipeline``'s
batches equal, and ``length_balanced_batches``' batches and waste equal
at p = 4 (the reference test's law of lengths, ``min(32 + zipf(1.5) %
992, 1024)``: massively duplicated keys), with the port's ``psort`` on
its CPU path."""
import numpy as np
import pytest

import repro.core  # noqa: F401  (turns on jax_enable_x64)
from repro.data import pipeline as JP
from repro_torch.core.selection import select_algorithm
from repro_torch.data import pipeline as P


def _lengths(n, seed=3):
    rng = np.random.default_rng(seed)
    return np.minimum(32 + (rng.zipf(1.5, size=n) % 992), 1024)


@pytest.mark.parametrize("family", ["dense", "audio"])
def test_token_pipeline_equal(family):
    kw = dict(seed=5, family=family, d_model=8, n_codebooks=4)
    a, b = P.TokenPipeline(300, 4, 16, **kw), JP.TokenPipeline(300, 4, 16,
                                                               **kw)
    for step, (x, y) in zip(range(3), zip(a, b)):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
    for k, v in a.batch_at(7).items():
        np.testing.assert_array_equal(v, b.batch_at(7)[k])


@pytest.mark.parametrize("algorithm", ["rams", "rquick", "bitonic"])
@pytest.mark.parametrize("n,batch", [(1024, 16), (4000, 64)])
def test_length_balanced_batches_equal(algorithm, n, batch):
    lengths = _lengths(n, seed=n)
    want = JP.length_balanced_batches(lengths, batch=batch, p=4,
                                      algorithm=algorithm)
    got = P.length_balanced_batches(lengths, batch=batch, p=4,
                                    algorithm=algorithm, device="cpu")
    assert got[0].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert got[2] < got[1]


def test_non_robust_sort_drops_and_both_refuse():
    """SSort drops keys on these duplicates (overflow): fewer ids than
    batches need, and both packages fail the same reshape."""
    lengths = _lengths(1024, seed=1024)
    with pytest.raises(ValueError, match="cannot reshape"):
        JP.length_balanced_batches(lengths, batch=16, p=4, algorithm="ssort")
    with pytest.raises(ValueError, match="cannot reshape"):
        P.length_balanced_batches(lengths, batch=16, p=4, algorithm="ssort",
                                  device="cpu")


def test_length_balanced_batches_auto():
    """``"auto"`` sorts with the algorithm the port's selection picks;
    the batches are the reference's with that algorithm named."""
    lengths = _lengths(1024)
    algorithm = select_algorithm(1024, 4)
    got = P.length_balanced_batches(lengths, batch=16, p=4, device="cpu")
    want = JP.length_balanced_batches(lengths, batch=16, p=4,
                                      algorithm=algorithm)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_default_p_on_the_cpu_is_one():
    """The reference's ``min(8, devices)``: one device on the CPU, so one
    PE; the batches are those of p = 1 named."""
    lengths = _lengths(512)
    got = P.length_balanced_batches(lengths, batch=16, algorithm="rams",
                                    device="cpu")
    one = P.length_balanced_batches(lengths, batch=16, p=1,
                                    algorithm="rams", device="cpu")
    np.testing.assert_array_equal(got[0], one[0])
    # a stable sort by length: batch b holds the b-th run of 16
    np.testing.assert_array_equal(
        got[0].reshape(-1), np.argsort(lengths, kind="stable")[:512])
