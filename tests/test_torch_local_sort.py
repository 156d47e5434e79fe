"""The local sort's launch schedule (``bitonic.ops.schedule``: tile width,
merge passes from the longest valid prefix, ping-pong buffers, the tail
copied once) composed out of the plain tile sort and the plain merge pass,
against the plain stable sort.  On a CPU tensor ``local_sort_fast`` goes
straight to the plain sort, so these tests are where the schedule runs
off the card.  The plain launchers below write what the CUDA kernels write
and nothing else: the tile sort the sorted prefix into its output and the
tail into the tail buffer, a merge pass only inside the counts."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitonic as bt
from repro_torch.kernels.bitonic import ops
from repro_torch.kernels.bitonic import ref as bref

MARK = -12345                 # what a fresh buffer holds before any write


def _valid(keys, count):
    idx = torch.arange(keys.shape[1])[None, :]
    if count is None:
        return torch.ones_like(keys, dtype=torch.bool)
    return idx < count[:, None]


def _plain_launchers(tile, log):
    def tile_sort(keys, vals, count, ok, ov, tk, tv):
        ks, vs = bref.sort_tiles_ref(keys, vals, tile, count)
        valid = _valid(keys, count)
        ok.copy_(torch.where(valid, ks, ok))
        tk.copy_(torch.where(valid, tk, ks))
        if vals is not None:
            ov.copy_(torch.where(valid, vs, ov))
            tv.copy_(torch.where(valid, tv, vs))
        log.append(("tile_sort", tile))

    def run_merge(keys, vals, count, width, cmax, ok, ov):
        assert cmax > width and width % tile == 0
        ks, vs = bref.merge_runs_ref(keys, vals, width, count)
        valid = _valid(keys, count)
        ok.copy_(torch.where(valid, ks, ok))
        if vals is not None:
            ov.copy_(torch.where(valid, vs, ov))
        log.append(("run_merge", width))
    return tile_sort, run_merge


@pytest.fixture
def marked_buffers(monkeypatch):
    """Fresh buffers full of MARK, so that a position the schedule never
    writes shows in the result."""
    monkeypatch.setattr(torch, "empty_like",
                        lambda t: torch.full_like(t, MARK))


@pytest.mark.parametrize("tile", [16, 64, bt.TILE])
@pytest.mark.parametrize("C_tiles", [0.5, 1, 1.02, 3, 4, 7.3])
@pytest.mark.parametrize("counts", [None, "edges", "ragged"])
@pytest.mark.parametrize("with_vals", [True, False])
def test_schedule_of_plain_launches_is_the_stable_sort(
        marked_buffers, tile, C_tiles, counts, with_vals):
    C = max(1, int(C_tiles * tile))
    rows = 4
    g = np.random.default_rng(tile + C + len(str(counts)))
    keys = torch.from_numpy(g.integers(-5, 5, size=(rows, C)).astype(
        np.int32))
    keys[0, :3] = 2 ** 31 - 1                     # the pad word as a key
    vals = (torch.arange(rows * C, dtype=torch.int32).reshape(rows, C)
            if with_vals else None)
    if counts is None:
        count = None
    elif counts == "edges":
        count = torch.tensor([0, 1, C, C // 2], dtype=torch.int64)
    else:
        count = torch.from_numpy(g.integers(0, C + 1, size=rows))
    cmax = C if count is None else int(count.max())
    log = []
    ks, vs = ops.schedule(keys, vals, count, cmax,
                          *_plain_launchers(tile, log), tile=tile)
    rk, rv = bref.sort_ref(keys, vals, count)
    assert torch.equal(ks, rk)
    assert vs is None if vals is None else torch.equal(vs, rv)
    passes = ops.merge_passes(cmax, tile)
    assert log == [("tile_sort", tile)] + [("run_merge", tile << i)
                                           for i in range(passes)]


@pytest.mark.parametrize("cmax,passes", [
    (0, 0), (1, 0), (bt.TILE, 0), (bt.TILE + 1, 1), (2 * bt.TILE, 1),
    (2 * bt.TILE + 1, 2), (1 << 18, 5), ((1 << 18) + 1, 6),
    (2_196_992, 9)])
def test_merge_passes(cmax, passes):
    assert ops.merge_passes(cmax) == passes


def test_cpu_wrappers_take_the_count():
    """On CPU tensors the wrappers are the plain versions, count and all."""
    g = np.random.default_rng(3)
    C = bt.TILE + 5
    keys = torch.from_numpy(g.integers(-9, 9, size=(3, C)).astype(np.int32))
    vals = torch.arange(3 * C, dtype=torch.int32).reshape(3, C)
    count = torch.tensor([C, 7, 0])
    for got, want in (
            (bt.sort_tiles(keys, vals, count),
             bref.sort_tiles_ref(keys, vals, bt.TILE, count)),
            (bt.merge_runs(keys, vals, bt.TILE, count),
             bref.merge_runs_ref(keys, vals, bt.TILE, count)),
            (bt.local_sort_fast(keys, vals, count),
             bref.sort_ref(keys, vals, count))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tile_sort_register_network_sorts_every_0_1_input():
    """The comparators of ``sort16`` in csrc/bitonic.cu, read from the
    source, sort all 2^16 inputs of zeros and ones, hence every input
    (the 0-1 principle)."""
    src = (Path(ops.__file__).parent / "csrc" / "bitonic.cu").read_text()
    body = src[src.index("void sort16("):]
    body = body[:body.index("#undef CS")]
    net = [(int(a), int(b)) for a, b in re.findall(r"CS\((\d+), (\d+)\);",
                                                  body)]
    assert len(net) == 60 and all(0 <= a < b < 16 for a, b in net)
    x = (np.arange(1 << 16)[:, None] >> np.arange(16)[None, :]) & 1
    for a, b in net:
        x[:, a], x[:, b] = (np.minimum(x[:, a], x[:, b]),
                            np.maximum(x[:, a], x[:, b]))
    assert (np.diff(x, axis=1) >= 0).all()
