"""Algorithm selection from the α/β cost model (counterpart of
``repro/core/selection.py``; see there for the model, paper §IV, Table I).

The cost functions, ``select_algorithm`` and ``regime_table`` are the
reference's, term for term, so that both packages choose the same
algorithm from the same :class:`CostModel`; profiles written by either
package load into the other unchanged.

The machine constants are not the reference's.  ``alpha``, ``alpha_c``,
``alpha_hop``, ``beta``, ``local_rate`` and ``name`` have no defaults, and
:data:`DEFAULT_MODEL` is the profile that ``tools/calibrate_torch.py``
measured on an NVIDIA H100 (the sim layout: p PEs as rows of one card's
tensors), committed as ``repro_torch/profiles/h100-sim.json``.  It is read
on first use; without that file it raises, and never falls back to the
reference's TPU priors.  So ``psort(algorithm="auto")`` without a
``cost_model`` may choose differently from the reference's; given the
same model, both choose the same.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path
from typing import Dict, Optional

BYTES_PER_WORD = 4
DEFAULT_PROFILE = Path(__file__).resolve().parent.parent / "profiles" \
    / "h100-sim.json"


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Machine profile of the α/β cost model (the reference's fields).

    alpha      — seconds per point-to-point step;
    alpha_c    — seconds per fused-collective launch;
    alpha_hop  — seconds per hop of a fused collective, charged × p^(1/3);
    beta       — seconds per 32-bit word exchanged;
    local_rate — words/s of local sort/merge throughput;
    partition_rate — words/s of splitter partition (classify + rank +
                 histogram); ``None`` → ``local_rate``;
    slot_overhead — static slot provisioning factor of the a2a exchanges
                 (a property of the algorithms, not of the machine);
    alpha_inner, alpha_c_inner, beta_inner — the fast axis of a nested
                 mesh (``None`` = as the flat constants);
    io_beta    — seconds per 32-bit word across the host↔device link;
                 ``None`` → the reference's PCIe-class fallback;
    overlap    — fraction of the exchange and copy traffic hidden behind
                 compute, in [0, 1];
    meta       — free-form provenance (card, fit diagnostics, grid).

    The first six have no defaults: a profile names its machine and
    states its constants.
    """

    name: str
    alpha: float
    alpha_c: float
    alpha_hop: float
    beta: float
    local_rate: float
    partition_rate: Optional[float] = None
    slot_overhead: float = 2.2
    alpha_inner: Optional[float] = None      # intra-axis p2p step
    alpha_c_inner: Optional[float] = None    # intra-axis fused launch
    beta_inner: Optional[float] = None       # intra-axis s/word
    io_beta: Optional[float] = None          # host↔device s/word
    overlap: float = 0.0                     # hidden traffic fraction
    meta: Dict = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        if not (0.0 <= self.overlap <= 1.0):
            raise ValueError(f"CostModel.overlap must be in [0, 1], got "
                             f"{self.overlap}")

    # -- derived ----------------------------------------------------------

    def coll(self, p: float) -> float:
        """Cost of one fused collective at axis size p."""
        return self.alpha_c + self.alpha_hop * _hops(p)

    @property
    def a_inner(self) -> float:
        return self.alpha if self.alpha_inner is None else self.alpha_inner

    @property
    def ac_inner(self) -> float:
        return self.alpha_c if self.alpha_c_inner is None \
            else self.alpha_c_inner

    @property
    def b_inner(self) -> float:
        return self.beta if self.beta_inner is None else self.beta_inner

    def coll_inner(self, p: float) -> float:
        """One fused collective on the fast intra axis: launch cost only."""
        return self.ac_inner

    @property
    def part_rate(self) -> float:
        return self.local_rate if self.partition_rate is None \
            else self.partition_rate

    @property
    def io_b(self) -> float:
        """Host↔device seconds per word; the reference's PCIe-class
        fallback when unmeasured, so that both packages cost the same
        JSON alike."""
        return BYTES_PER_WORD / 16e9 if self.io_beta is None else self.io_beta

    # -- JSON round-trip --------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CostModel":
        raw = json.loads(text)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(f"unknown CostModel fields: {sorted(unknown)}")
        return cls(**raw)

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path) -> "CostModel":
        with open(path) as f:
            return cls.from_json(f.read())


def load_default(path=DEFAULT_PROFILE) -> CostModel:
    """The card's profile; raises ``FileNotFoundError`` without it."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(
            f"no cost profile at {path}: the port's DEFAULT_MODEL is the "
            f"profile tools/calibrate_torch.py measures on the card, and "
            f"there is no fallback; pass cost_model=CostModel.load(...)")
    return CostModel.load(path)


_DEFAULT: Optional[CostModel] = None


def __getattr__(name):
    # DEFAULT_MODEL is read from its file on first use, so importing the
    # package never needs it
    if name == "DEFAULT_MODEL":
        global _DEFAULT
        if _DEFAULT is None:
            _DEFAULT = load_default()
        return _DEFAULT
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _model(model: Optional[CostModel]) -> CostModel:
    return model if model is not None else __getattr__("DEFAULT_MODEL")


def _d(p):
    return math.log2(max(2, p))


def _hops(p):
    return p ** (1.0 / 3.0)         # 3-D torus diameter-ish


def _lg(n):
    return math.log2(max(2, n))


def cost_gatherm(n, p, model: Optional[CostModel] = None):
    # binomial tree: d steps; root ingests all n words single-ported
    m = _model(model)
    return m.alpha * _d(p) + m.beta * n + n / m.local_rate


def cost_allgatherm(n, p, model: Optional[CostModel] = None):
    # doubling: volume doubles per step → ~2n per PE; all PEs merge n words
    m = _model(model)
    return m.alpha * _d(p) + m.beta * 2 * n + n / m.local_rate


def cost_rfis(n, p, model: Optional[CostModel] = None):
    m = _model(model)
    d, sq = _d(p), math.sqrt(p)
    row = n / sq
    return (m.alpha * 2 * d                     # row+col gathers, routing
            + m.beta * 3 * row                  # 2 gathers + delivery
            + (2 * row * _lg(row) + row) / m.local_rate)  # merges + ranking


def cost_rquick(n, p, model: Optional[CostModel] = None):
    m = _model(model)
    d = _d(p)
    npp = n / p
    return (m.alpha * (d * (d + 1) / 2)         # per-dim median butterflies
            + m.alpha * 2 * d                   # shuffle + exchanges
            + m.beta * npp * (2 * d)            # shuffle + per-dim halves
            + npp * _lg(n) / m.local_rate       # local sort
            + npp * d / m.part_rate)            # per-dim pivot partition


def cost_rams(n, p, levels=None, model: Optional[CostModel] = None,
              mesh_shape=None):
    m = _model(model)
    npp = n / p
    d = _d(p)
    if mesh_shape is not None:
        return _cost_rams_nested(n, p, levels, m, mesh_shape)
    l = levels or max(1, min(3, round(d / 6)))
    k = p ** (1.0 / l)
    # the streamed exchange pipeline (comm.alltoall_stream) hides a measured
    # ``overlap`` fraction of every slotted a2a behind the incremental merge
    ov = 1.0 - m.overlap
    return ((3 * l + 1) * m.coll(p)             # samples, hist, a2a / level
            + m.beta * npp * (m.slot_overhead * l + 1) * ov  # exch + shuffle
            + npp * _lg(n) / m.local_rate       # local sort
            + npp * l * _lg(k) / m.part_rate)   # k-way partition per level


def _cost_rams_nested(n, p, levels, m: CostModel, mesh_shape):
    """Hierarchical RAMS on an (outer × inner) mesh: only the shuffle and
    the first (outer-axis) level cross the slow links — they alone are
    charged ``alpha_hop`` pipeline fill and the slow-link ``beta``; every
    later level runs inside an intra subcube at the inner-axis constants
    (the 1410.6754 multi-level argument for why deep hierarchies win)."""
    p_o, p_i = mesh_shape
    npp = n / p
    ov = 1.0 - m.overlap               # streamed-exchange discount (see flat)
    if p_o <= 1:                       # pure-intra: no slow-axis level
        l = levels or max(1, min(3, round(_d(p_i) / 6)))
        k = max(2.0, p_i ** (1.0 / l))
        return ((3 * l + 1) * m.coll_inner(p_i)
                + m.b_inner * npp * (m.slot_overhead * l + 1) * ov
                + npp * _lg(n) / m.local_rate
                + npp * l * _lg(k) / m.part_rate)
    l_i = 0 if p_i <= 1 or levels == 1 else \
        (max(1, levels - 1) if levels else
         max(1, min(3, round(_d(p_i) / 6))))
    l = 1 + l_i
    # shuffle + level 0 span the whole mesh: one slow-axis stage plus one
    # intra stage each (the NestedCollectives decomposition)
    outer = (4 * m.coll(p) + 4 * m.coll_inner(p_i)
             + m.beta * npp * (m.slot_overhead + 1) * ov
             + m.b_inner * npp * (m.slot_overhead + 1) * ov)
    inner = (3 * l_i * m.coll_inner(p_i)
             + m.b_inner * npp * m.slot_overhead * l_i * ov)
    k = max(2.0, p ** (1.0 / l))
    local = npp * _lg(n) / m.local_rate + npp * l * _lg(k) / m.part_rate
    return outer + inner + local


def cost_bitonic(n, p, model: Optional[CostModel] = None):
    m = _model(model)
    d = _d(p)
    npp = n / p
    steps = d * (d + 1) / 2
    return m.alpha * steps + m.beta * npp * steps + \
        (npp * _lg(n) + npp * steps) / m.local_rate


def cost_ssort(n, p, model: Optional[CostModel] = None):
    m = _model(model)
    npp = n / p
    # p-way splitter selection: 16·lg p samples per PE are all-gathered, so
    # every PE receives a Θ(p log p)-word sample volume — the term that
    # makes single-level sample sort need n = Ω(p²/log p) to be efficient
    # (paper §VII).  Each PE also scans the p-sized splitter set locally.
    # Only the slotted data exchange streams — the sample gather does not.
    return (m.coll(p) * 3
            + m.beta * (npp * m.slot_overhead * (1.0 - m.overlap)
                        + 16 * _lg(p) * p)
            + m.alpha_hop * _hops(p)
            + npp * _lg(n) / m.local_rate       # local sort
            + p / m.part_rate)                  # p-way splitter scan


def cost_external(n, p, budget, model: Optional[CostModel] = None):
    """Two-pass out-of-core sort of n/p words through a ``budget``-word
    device window (arXiv 0910.2582's pass structure on one device each):

      * every element crosses the host↔device link ~3× per pass (in, out,
        and once more through the merge's chunk staging) — 6·n/p words of
        streaming traffic, discounted by the measured ``overlap`` the
        double-buffered copies achieve (cf. arXiv 1410.6754);
      * R run-formation launches plus the splitter fit and the merge
        barrier cost one fused collective each;
      * one all-to-all per pass moves the slot-provisioned run slices;
      * the device sorts each window twice (runs, then merged chunks) and
        classifies every element against p splitters per pass.
    """
    m = _model(model)
    npp = max(1.0, n / p)
    budget = max(1, budget)
    runs = max(1.0, math.ceil(npp / budget))
    io = 6 * npp * m.io_b * (1.0 - m.overlap)   # range-checked in __post_init__
    coll = (runs + 2) * m.coll(p)
    wire = m.beta * npp * m.slot_overhead
    local = 2 * npp * _lg(min(npp, budget)) / m.local_rate
    classify = 2 * npp * _lg(p) / m.part_rate
    return io + coll + wire + local + classify


def cost_select(n, p, query: str = "percentile", batch: int = 1,
                k: Optional[int] = None, bits: int = 32,
                model: Optional[CostModel] = None):
    """Cost of answering a ``batch`` of queries via the selection fast
    path of ``core/queries.py`` — i.e. *without* sorting.

    ``rank_of_key`` / ``range_query`` are pure counting: one fused psum
    over per-PE ``searchsorted`` ranks.  ``percentile`` / ``top_k`` run
    the exact rank selection: one §III-B butterfly window (d p2p steps),
    then ``ceil(bits/4)`` static refinement rounds of (sketch all_gather
    + count psum) with ~32 candidates × batch binary searches against the
    resident shard each, plus a verify psum; top-k adds the local tail
    extraction (≤ k words per PE).  Every term is O(polylog) in n — the
    crossover against :data:`COSTS` is what makes the fast path a *regime*
    rather than an always-win.
    """
    m = _model(model)
    npp = max(1.0, n / p)
    search = _lg(npp) / m.local_rate            # one binary search
    if query in ("rank_of_key", "range_query"):
        nq = batch * (2 if query == "range_query" else 1)
        return m.coll(p) + nq * search
    if query not in ("percentile", "top_k"):
        raise ValueError(f"cost_select: unknown query kind {query!r}")
    rounds = -(-bits // 4)                      # queries.n_rounds
    ncand = 32 + 16                             # grid+sketch, window round 0
    cost = (m.alpha * _d(p)                     # butterfly rank window
            + (2 * rounds + 1) * m.coll(p)      # gather+psum / round, verify
            + rounds * ncand * batch * search   # candidate ranking
            + rounds * 16 * batch * p * _lg(16 * p) / m.local_rate)  # sketch
    if query == "top_k":
        cost += batch * (k or 16) / m.local_rate    # tail extraction
    return cost


COSTS = {
    "gatherm": cost_gatherm,
    "rfis": cost_rfis,
    "rquick": cost_rquick,
    "rams": cost_rams,
}

QUERY_KINDS = ("sort", "top_k", "rank_of_key", "percentile", "range_query")


def select_algorithm(n: int, p: Optional[int] = None,
                     model: Optional[CostModel] = None,
                     levels: Optional[int] = None,
                     mesh_shape=None, budget: Optional[int] = None,
                     query: Optional[str] = None, batch: int = 1,
                     k: Optional[int] = None, bits: int = 32,
                     config=None) -> str:
    """The paper's four-regime selection: the argmin of the model costs
    (the reference's ``select_algorithm``, rule for rule).

    GatherM is a candidate only for very sparse inputs (n ≤ max(8, p/8)),
    RAMS only for n > 4p.  ``model`` defaults to :data:`DEFAULT_MODEL`, the
    card's profile.  ``levels``/``mesh_shape`` cost the RAMS candidate as
    ``psort`` would run it.  ``budget`` adds the external regime: n/p above
    it selects ``"external"``.  ``query`` (a kind of ``QUERY_KINDS`` other
    than ``"sort"``) weighs the sort-free selection path
    (:func:`cost_select`) against a whole sort and returns ``"selection"``
    when it is cheaper.  ``config`` (a ``SortConfig``, duck-typed) fills
    whichever of p, model, levels, mesh_shape and budget were not passed.
    """
    if config is not None:
        p = p if p is not None else config.p
        model = model if model is not None else config.cost_model
        levels = levels if levels is not None else config.levels
        mesh_shape = mesh_shape if mesh_shape is not None \
            else getattr(config, "mesh_shape", None)
        if budget is None and config.external is not None:
            budget = config.external.budget
    if p is None and mesh_shape is not None:
        p = int(mesh_shape[0]) * int(mesh_shape[1])
    if p is None:
        raise TypeError("select_algorithm() needs p — directly or via "
                        "config=SortConfig(p=... | mesh_shape=...)")
    sorting = query is None or query == "sort"
    if sorting and budget is not None and n / p > budget:
        return "external"          # decided before any cost is read
    m = _model(model)
    if not sorting:
        if query not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {query!r}; "
                             f"know {QUERY_KINDS}")
        algo = select_algorithm(n, p, model=m, levels=levels,
                                mesh_shape=mesh_shape, budget=budget)
        c_sort = cost_external(n, p, budget, model=m) \
            if algo == "external" else \
            (cost_rams(max(1, n), p, levels=levels, model=m,
                       mesh_shape=mesh_shape) if algo == "rams"
             else COSTS[algo](max(1, n), p, model=m))
        c_sel = cost_select(n, p, query=query, batch=batch, k=k, bits=bits,
                            model=m)
        return "selection" if c_sel < c_sort else algo
    cands = dict(COSTS)
    if n > max(8, p // 8):
        cands.pop("gatherm")
    if n <= 4 * p:
        cands.pop("rams", None)

    def cost(a):
        if a == "rams":
            return cost_rams(max(1, n), p, levels=levels, model=m,
                             mesh_shape=mesh_shape)
        return cands[a](max(1, n), p, model=m)

    return min(cands, key=cost)


def regime_table(p: int, exponents=range(-8, 24),
                 model: Optional[CostModel] = None,
                 levels: Optional[int] = None, mesh_shape=None,
                 budget: Optional[int] = None):
    """n/p sweep → selected algorithm, one (e, n, algorithm) row per
    exponent e of n/p = 2^e.
    ``levels`` / ``mesh_shape`` / ``budget`` forward to the costs exactly
    as :func:`select_algorithm` does."""
    rows = []
    for e in exponents:
        n = max(1, int(p * (2.0 ** e)))
        rows.append((e, n, select_algorithm(n, p, model=model, levels=levels,
                                            mesh_shape=mesh_shape,
                                            budget=budget)))
    return rows
