"""State-space blocks (counterpart of ``repro/models/ssm.py``): Mamba2
(SSD, chunked) and RWKV6 (Finch, chunked WKV), with their one-token
decode steps against an explicit recurrent state.

Both prefill paths are the reference's chunked formulation: dense
einsums inside a chunk under a decay mask, and the state carried from
chunk to chunk by a loop (the reference's ``lax.scan``).  Decays are
accumulated in log space per chunk, in float32.

On a mesh a block's part carries a ``layers.Split`` (``p.tp``) whose
``take`` gives this rank's slices of its weights split where the layer
asks.  Where ``model`` divides the heads (and, mamba2, both widths its
weights split on), the block runs on the rank's block of whole heads,
which is a contiguous block of ``d`` (rwkv6) or ``di`` (mamba2):

- rwkv6's time mix takes the rank's slice of ``d`` of the token-shift
  mix times its rows of ``wr``/``wk``/``wv``/``wg`` and reduce-scatters
  the partial products onto its heads; the decay's LoRA sums
  ``xs[3]``'s slice times ``wA``'s rows over ``model`` and multiplies
  the rank's columns of ``wB``; the WKV runs on the rank's heads, the
  output norm over the whole ``d`` (``layers.rms_norm_split``), and its
  rows of ``wo`` give partial products summed over ``model``.  The
  channel mix is the dense MLP's pattern (``layers.mlp``).
- mamba2 multiplies the rank's columns of ``in_proj`` and gathers the
  product's columns over ``model`` (they do not line up with the five
  parts it concatenates), convolves its channels of ``[x, B, C]`` and
  gathers those: every rank holds the whole ``x``, ``z``, ``B``, ``C``
  and ``dt`` of its rows, and keeps its heads' ``x``, ``z`` and ``dt``.
  The SSD runs on its heads, the norm over the whole ``di``, and its
  rows of ``out_proj`` give partial products summed over ``model``.

A decode step runs its state where the reference's rule puts it
(``dist.sharding.cache_split_dim``): rwkv6's ``wkv`` on every head's
slice of hd_k (else the rank's heads), mamba2's ``ssm`` on every head's
slice of P (else its heads).  On the key split a rank re-lays ``r``,
``k`` and the decay from its heads to its key slices
(``dist.sharding.relay_heads``) and sums ``v`` whole; ``rᵀ·S`` is then a
partial product over hd_k, reduce-scattered onto the rank's heads.  On
P the rank updates its slice of every head and re-lays ``y`` back to
its heads.  mamba2's conv window stays whole on every rank along
``model`` (3 slots, which ``model`` rarely divides) and every rank
writes the token's whole slot, the same bits; a window split on its
slots is gathered for the step.  Where ``model`` divides none of this
the block gathers its weights whole and runs as on one device, on the
state's slice.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.sharding import (block_slices, cache_split_dim,
                                       gather_blocks, relay_heads,
                                       sum_partials)

from .layers import (full, mlp, normal, rms_norm, rms_norm_split,
                     tp_reduce)

CHUNK = 128


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in float64 where it is (a float64 run)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


class Mamba2(nn.Module):
    def __init__(self, d: int, n_heads: int, d_state: int, dtype, device,
                 gen: Optional[torch.Generator] = None, expand: int = 2,
                 d_conv: int = 4):
        super().__init__()
        di = expand * d
        s = 1.0 / math.sqrt(d)
        self.in_proj = normal(gen, (d, 2 * di + 2 * d_state + n_heads),
                              dtype, s, device)
        self.conv = normal(gen, (d_conv, di + 2 * d_state), dtype, 0.1,
                           device)
        self.A_log = full((n_heads,), 0.0, device)
        self.D = full((n_heads,), 1.0, device)
        self.dt_bias = full((n_heads,), 0.0, device)
        self.norm = full((di,), 1.0, device)
        self.out_proj = normal(gen, (di, d), dtype, 1.0 / math.sqrt(di),
                               device)


class MambaState(NamedTuple):
    ssm: torch.Tensor       # (B, H, hd, N) f32
    conv: torch.Tensor      # (B, d_conv-1, conv_dim)


def _mamba_split(z, di, d_state, H):
    return torch.split(z, [di, di, d_state, d_state, H], dim=-1)


_MAMBA = ("in_proj", "conv", "A_log", "D", "dt_bias", "norm", "out_proj")


def _model_block(n: int, mesh) -> slice:
    """This rank's block of a dimension of ``n`` cut over ``model``."""
    return block_slices((n,), [("model",)], mesh)[0]


def _mamba_part(p, cfg, d: int, whole=()):
    """(the block's weights as this rank uses them, the ``Split`` where
    it runs on its heads, else None).  It runs on its heads where
    ``model`` divides them, ``in_proj``'s columns and ``conv``'s
    channels: its columns of ``in_proj`` and ``conv``, its rows of
    ``out_proj`` and its heads' slices of ``norm``, ``A_log``, ``D`` and
    ``dt_bias``, the names in ``whole`` whole; else every weight
    whole."""
    sp = getattr(p, "tp", None)
    if sp is None:
        return p, None
    H, N, di = cfg.ssm_heads, cfg.ssm_state, 2 * d
    if H % sp.m or (2 * di + 2 * N + H) % sp.m or (di + 2 * N) % sp.m:
        return SimpleNamespace(**sp.take({n: None for n in _MAMBA})), None
    want = {"in_proj": 1, "conv": 1, "out_proj": 0, "norm": 0, "A_log": 0,
            "D": 0, "dt_bias": 0}
    want.update({n: None for n in whole})
    return SimpleNamespace(**sp.take(want)), sp


def _mamba_in(x, p, sp):
    """``x @ in_proj`` whole: with ``sp`` the rank's columns, the
    product's blocks gathered over ``model``."""
    if sp is None:
        return x @ p.in_proj
    return gather_blocks(x @ p.in_proj, sp.mesh, ("model",), dim=x.ndim - 1)


def _mamba_conv(conv_of, xbc, p, sp):
    """``silu(conv_of(xbc, weight))`` whole: with ``sp`` on the rank's
    channels of ``xbc`` (its slice of ``conv``), gathered over
    ``model``."""
    if sp is None:
        return F.silu(conv_of(xbc, p.conv))
    out = F.silu(conv_of(xbc[..., sp.block(xbc.shape[-1])], p.conv))
    return gather_blocks(out, sp.mesh, ("model",), dim=out.ndim - 1)


def _mamba_out(y, zgate, p, sp, dtype):
    """The gated norm and ``out_proj`` of ``y``: whole, or with ``sp`` the
    rank's heads' channels (its ``norm`` and ``out_proj`` rows), the norm
    over the whole ``di`` and the partial products summed over
    ``model``."""
    norm = rms_norm if sp is None else (
        lambda t, w: rms_norm_split(t, w, sp))
    y = norm(y, p.norm) * F.silu(zgate.float()).to(y.dtype)
    out = y.to(dtype) @ p.out_proj
    return out if sp is None else sum_partials(out, sp.mesh)


def _causal_conv(xbc, w):
    """The causal depthwise conv of ``xbc`` (B, S, C) with ``w`` (k, C)."""
    k, S = w.shape[0], xbc.shape[1]
    pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[-1]))
    xbc_p = torch.cat([pad, xbc], dim=1)
    return sum(xbc_p[:, i:i + S] * w[i][None, None] for i in range(k))


def mamba2(xin: torch.Tensor, p, cfg) -> torch.Tensor:
    """Prefill path, chunked SSD.  xin: (B, S, D)."""
    Bsz, S, D = xin.shape
    H = cfg.ssm_heads
    N = cfg.ssm_state
    di = 2 * D
    hd = di // H
    p, sp = _mamba_part(p, cfg, D)
    z = _mamba_in(xin, p, sp)
    x, zgate, Bm, Cm, dt = _mamba_split(z, di, N, H)
    # causal depthwise conv over (x, B, C)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    conv = _mamba_conv(_causal_conv, xbc, p, sp)
    x, Bm, Cm = torch.split(conv, [di, N, N], dim=-1)
    if sp is not None:                   # the rank's heads
        x, zgate = x[..., sp.block(di)], zgate[..., sp.block(di)]
        dt = dt[..., sp.block(H)]

    dt = F.softplus(_wide(dt) + p.dt_bias)                        # (B,S,H)
    A = -torch.exp(p.A_log)                                        # (H,)
    xh = x.reshape(Bsz, S, -1, hd)
    y, _ = _ssd_chunked(xh, dt, A, Bm, Cm, chunk=min(CHUNK, S))
    y = y + xh * p.D.to(xh.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, -1)
    return _mamba_out(y, zgate, p, sp, xin.dtype)


def _ssd_chunked(x, dt, A, B, C, chunk: int = CHUNK):
    """SSD: y_t = C_t · h_t,  h_t = exp(A·dt_t)·h_{t-1} + dt_t·B_t x_t.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); B,C: (B,S,N) (single group).
    Returns (y (B,S,H,P), final state (B,H,P,N))."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = _wide(B.reshape(Bsz, nc, chunk, N))
    Cc = _wide(C.reshape(Bsz, nc, chunk, N))

    da = dtc * A[None, None, None, :]                  # (B,nc,c,H) ≤ 0
    cum = torch.cumsum(da, dim=2)                      # inclusive
    seg_sum = cum[:, :, -1:, :]                        # (B,nc,1,H)

    xdt = _wide(xc) * dtc[..., None]
    # intra-chunk: y_i += Σ_{j≤i} C_i·B_j · exp(cum_i - cum_j) · dt_j x_j
    scores = torch.einsum("bnif,bnjf->bnij", Cc, Bc)   # (B,nc,c,c)
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,i,j,H)
    ar = torch.arange(chunk, device=x.device)
    mask = ar[:, None] >= ar[None, :]
    w = torch.where(mask[None, None, :, :, None], torch.exp(decay), 0.0)
    y_intra = torch.einsum("bnij,bnijh,bnjhp->bnihp", scores, w, xdt)

    # chunk states: G_n = Σ_j exp(seg_sum - cum_j) · B_j ⊗ dt_j x_j
    wj = torch.exp(seg_sum - cum)                      # (B,nc,c,H)
    G = torch.einsum("bnjf,bnjh,bnjhp->bnhpf", Bc, wj, xdt)  # (B,nc,H,P,N)

    # carry states across chunks:  h_n = exp(seg_sum_n)·h_{n-1} + G_n
    seg = torch.exp(seg_sum[:, :, 0, :])               # (B,nc,H)
    h = torch.zeros((Bsz, H, P, N), dtype=xdt.dtype, device=x.device)
    hs = []
    for n in range(nc):
        h = h * seg[:, n, :, None, None] + G[:, n]
        hs.append(h)
    hs = torch.stack(hs, dim=1)                        # (B,nc,H,P,N) inclusive
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    # inter-chunk: y_i += C_i · exp(cum_i) · h_prev
    y_inter = torch.einsum("bnif,bnih,bnhpf->bnihp",
                           Cc, torch.exp(cum), h_prev)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P).to(x.dtype)
    return y, hs[:, -1]


def mamba2_decode(xin: torch.Tensor, p, cfg, state: MambaState,
                  mesh=None):
    """One-token decode.  xin: (B, 1, D); ``state`` this rank's slice of
    its layer's (``mesh``: where the reference's rule splits it)."""
    Bsz, _, D = xin.shape
    H, N = cfg.ssm_heads, cfg.ssm_state
    di = 2 * D
    hd = di // H
    split = cache_split_dim((Bsz, H, hd, N), mesh)     # 2: P, 1: heads
    p, sp = _mamba_part(p, cfg, D, whole=("A_log", "D", "dt_bias"))
    z = _mamba_in(xin[:, 0], p, sp)
    x, zgate, Bm, Cm, dt = _mamba_split(z, di, N, H)
    xbc = torch.cat([x, Bm, Cm], dim=-1)               # (B, convdim)
    window = state.conv
    slots = cache_split_dim((Bsz, 3, xbc.shape[-1]), mesh)
    if slots is not None:
        window = gather_blocks(window, mesh, ("model",), dim=1)
    hist = torch.cat([window, xbc[:, None]], dim=1)    # (B,k,convdim)
    conv = _mamba_conv(lambda t, w: torch.einsum("bkc,kc->bc", t, w),
                       hist, p, sp)
    x, Bm, Cm = torch.split(conv, [di, N, N], dim=-1)
    # the state's slice: every head's block of P, or a block of heads
    heads = _model_block(H, mesh) if split == 1 else slice(None)
    ps = _model_block(hd, mesh) if split == 2 else slice(None)
    dt = F.softplus(_wide(dt[:, heads]) + p.dt_bias[heads])   # (B,H)
    A = -torch.exp(p.A_log[heads])
    xh = _wide(x.reshape(Bsz, H, hd)[:, heads, ps])
    decay = torch.exp(dt * A[None])                    # (B,H)
    upd = torch.einsum("bhp,bf,bh->bhpf", xh, _wide(Bm), dt)
    ssm = state.ssm * decay[..., None, None] + upd
    y = torch.einsum("bf,bhpf->bhp", _wide(Cm), ssm)
    y = y + xh * p.D[heads][None, :, None]
    if split is not None and sp is not None:           # to the rank's heads
        if split == 2:
            y = relay_heads([y.reshape(Bsz, -1)], mesh, H, False)[0]
        zgate = zgate[:, sp.block(di)]
    elif split is not None:                            # whole
        y = gather_blocks(y, mesh, ("model",), dim=split)
    out = _mamba_out(y.reshape(Bsz, -1), zgate, p, sp, xin.dtype)[:, None]
    hist = hist[:, 1:]
    if slots is not None:
        hist = hist[:, _model_block(3, mesh)]
    return out, MambaState(ssm=ssm, conv=hist)


# ===========================================================================
# RWKV6 (Finch): data-dependent per-channel decay
# ===========================================================================


class RWKV6(nn.Module):
    def __init__(self, d: int, n_heads: int, dtype, device,
                 gen: Optional[torch.Generator] = None, lora: int = 64):
        super().__init__()
        s = 1.0 / math.sqrt(d)
        hd = d // n_heads
        self.mu = full((5, d), 0.5, device)      # token-shift mix r,k,v,w,g
        self.wr = normal(gen, (d, d), dtype, s, device)
        self.wk = normal(gen, (d, d), dtype, s, device)
        self.wv = normal(gen, (d, d), dtype, s, device)
        self.wg = normal(gen, (d, d), dtype, s, device)
        self.wo = normal(gen, (d, d), dtype, s, device)
        # data-dependent decay lora: w = exp(-exp(w0 + tanh(x A) B))
        self.w0 = full((d,), -6.0, device)
        self.wA = normal(gen, (d, lora), dtype, s, device)
        self.wB = normal(gen, (lora, d), dtype, 1.0 / math.sqrt(lora),
                         device)
        self.u = full((n_heads, hd), 0.0, device)  # bonus for current token
        self.ln_x = full((d,), 1.0, device)


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, hd_k, hd_v) f32
    last: torch.Tensor      # (B, D) previous token features


_TIME = ("mu", "wr", "wk", "wv", "wg", "wo", "w0", "wA", "wB", "u", "ln_x")


def _time_part(p, cfg, u_dim: int = 0):
    """(the time mix's weights as this rank uses them, the ``Split``
    where it runs on its block of heads, else None).  On its heads (where
    ``model`` divides them): its slices of ``d`` of ``mu`` and ``w0``
    and ``ln_x``, its rows of ``wr``/``wk``/``wv``/``wg``/``wo``/``wA``,
    its columns of ``wB``, and ``u`` split on ``u_dim`` (0: its heads, 1:
    every head's slice of hd); else every weight whole."""
    sp = getattr(p, "tp", None)
    if sp is None:
        return p, None
    if cfg.n_heads % sp.m:
        return SimpleNamespace(**sp.take({n: None for n in _TIME})), None
    return SimpleNamespace(**sp.take({
        "mu": 1, "wr": 0, "wk": 0, "wv": 0, "wg": 0, "wo": 0, "w0": 0,
        "wA": 0, "wB": 1, "u": u_dim, "ln_x": 0})), sp


def _rwkv_proj(x, xprev, p, sp=None, whole_v: bool = False):
    """Token-shift mixing + projections.  x: (B,S,D); xprev: shifted x.
    With ``sp`` (``x``, ``xprev`` the same on every rank along ``model``,
    ``p`` the rank's slices from :func:`_time_part`) r, k, g and the log
    decay of the rank's heads, and v of its heads or, ``whole_v``, of
    every head."""
    mu = p.mu.to(x.dtype)
    if sp is not None:                   # the rank's slice of d
        x, xprev = x[..., sp.block(x.shape[-1])], \
            xprev[..., sp.block(xprev.shape[-1])]
    xs = [xprev + mu[i][None, None] * (x - xprev) for i in range(5)]
    r = xs[0] @ p.wr
    k = xs[1] @ p.wk
    v = xs[2] @ p.wv
    lora = _wide(xs[3]) @ _wide(p.wA)
    g = xs[4] @ p.wg
    if sp is not None:                   # partial products over model
        if whole_v:
            r, k, g = tp_reduce([r, k, g], sp, True)
            lora, v = tp_reduce([lora, v], sp, False)
            v = v.to(x.dtype)
        else:
            r, k, v, g = tp_reduce([r, k, v, g], sp, True)
            lora, = tp_reduce([lora], sp, False)
    lw = p.w0 + torch.tanh(lora) @ _wide(p.wB)
    logw = -torch.exp(lw)                               # log decay ≤ 0
    g = F.silu(g)
    return r, k, v, logw, g


def _rwkv_out(y, g, p, sp, dtype):
    """``(rms_norm(y) · g) @ wo``: whole, or with ``sp`` the rank's heads'
    channels (its ``ln_x`` and rows of ``wo``), the norm over the whole
    ``d`` and the partial products summed over ``model``."""
    if sp is None:
        return (rms_norm(y.to(dtype), p.ln_x) * g) @ p.wo
    y = rms_norm_split(y.to(dtype), p.ln_x, sp) * g
    return sum_partials(y @ p.wo, sp.mesh)


def rwkv6(xin: torch.Tensor, p, cfg) -> torch.Tensor:
    """Chunked WKV.  xin: (B, S, D)."""
    B, S, D = xin.shape
    hd = D // cfg.n_heads
    p, sp = _time_part(p, cfg)
    xprev = torch.cat([torch.zeros_like(xin[:, :1]), xin[:, :-1]], dim=1)
    r, k, v, logw, g = _rwkv_proj(xin, xprev, p, sp)
    rh = _wide(r.reshape(B, S, -1, hd))
    kh = _wide(k.reshape(B, S, -1, hd))
    vh = _wide(v.reshape(B, S, -1, hd))
    lw = logw.reshape(B, S, -1, hd)
    y = _wkv_chunked(rh, kh, vh, lw, p.u, chunk=min(CHUNK, S))
    return _rwkv_out(y.reshape(B, S, -1), g, p, sp, xin.dtype)


def _wkv_chunked(r, k, v, lw, u, chunk: int = CHUNK):
    """WKV recurrence, chunked:
       S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ ;
       y_t = rᵀ_t (S_{t-1} + diag(u)·k_t v_tᵀ)
    r,k,v: (B,S,H,K);  lw: log decays (B,S,H,K);  u: (H,K)."""
    B, S, H, K = r.shape
    nc = S // chunk
    rc = r.reshape(B, nc, chunk, H, K)
    kc = k.reshape(B, nc, chunk, H, K)
    vc = v.reshape(B, nc, chunk, H, K)
    lwc = lw.reshape(B, nc, chunk, H, K)
    cum = torch.cumsum(lwc, dim=2)                      # inclusive decay sums
    seg = cum[:, :, -1]                                 # (B,nc,H,K)

    # intra-chunk: y_i = Σ_{j<i} (r_i·exp(cum_{i-1}-cum_j)·k_j) v_j
    #                    + (r_i·u·k_i) v_i
    cum_ex = cum - lwc                                  # exclusive prefix
    ri = rc * torch.exp(cum_ex)
    kj = kc * torch.exp(-cum)
    att = torch.einsum("bnihk,bnjhk->bnhij", ri, kj)
    mask = torch.tril(torch.ones((chunk, chunk), device=r.device), -1)
    att = att * mask[None, None, None]
    diag = torch.einsum("bnihk,hk,bnihk->bnih", rc, u, kc)
    y_intra = torch.einsum("bnhij,bnjhv->bnihv", att, vc) \
        + diag[..., None] * vc

    # chunk state updates: G_n = Σ_j exp(seg - cum_j) k_j ⊗ v_j
    wk = torch.exp(seg[:, :, None] - cum) * kc          # (B,nc,c,H,K)
    G = torch.einsum("bnjhk,bnjhv->bnhkv", wk, vc)
    segd = torch.exp(seg)                               # (B,nc,H,K)

    state = torch.zeros((B, H, K, K), dtype=r.dtype, device=r.device)
    prev = []                                           # the state before
    for n in range(nc):                                 # each chunk
        prev.append(state)
        state = state * segd[:, n, ..., None] + G[:, n]
    Sprev = torch.stack(prev, dim=1)                    # (B,nc,H,K,V)
    y_inter = torch.einsum("bnihk,bnhkv->bnihv", rc * torch.exp(cum_ex),
                           Sprev)
    return (y_intra + y_inter).reshape(B, S, H, K)


def rwkv6_decode(xin: torch.Tensor, p, cfg, state: RWKVState, mesh=None):
    """One-token decode.  xin: (B, 1, D); ``state`` this rank's slice of
    its layer's (``mesh``: ``wkv`` where the reference's rule splits
    it)."""
    B, _, D = xin.shape
    H = cfg.n_heads
    hd = D // H
    split = cache_split_dim((B, H, hd, hd), mesh)      # 2: hd_k, 1: heads
    p, sp = _time_part(p, cfg, u_dim=1 if split == 2 else 0)
    xprev = state.last[:, None].to(xin.dtype)
    r, k, v, logw, g = _rwkv_proj(xin, xprev, p, sp, whole_v=split == 2)
    r, k, v, logw = (t[:, 0] for t in (r, k, v, logw))
    u = p.u
    if split == 2:                   # every head's slice of its keys
        if sp is not None:
            r, k, logw = relay_heads([r, k, logw], mesh, H, True)
        else:
            keys = _model_block(hd, mesh)
            r, k, logw = (t.reshape(B, H, hd)[..., keys]
                          for t in (r, k, logw))
            u = u[:, keys]
    elif split == 1 and sp is None:  # the rank's heads of every head's
        heads = _model_block(H, mesh)
        r, k, v, logw = (t.reshape(B, H, hd)[:, heads]
                         for t in (r, k, v, logw))
        u = u[heads]
    Hs, Ks = state.wkv.shape[1:3]
    rh = _wide(r.reshape(B, Hs, Ks))
    kh = _wide(k.reshape(B, Hs, Ks))
    vh = _wide(v.reshape(B, Hs, hd))
    w = torch.exp(logw.reshape(B, Hs, Ks))
    y = torch.einsum("bhk,bhkv->bhv", rh, state.wkv) \
        + torch.einsum("bhk,hk,bhk,bhv->bhv", rh, u, kh, vh)
    wkv = state.wkv * w[..., None] + torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = y.reshape(B, -1)
    if split == 2:                   # partial over hd_k
        y = tp_reduce([y], sp, True)[0] if sp is not None \
            else sum_partials(y, mesh)
    elif split == 1 and sp is None:
        y = gather_blocks(y, mesh, ("model",), dim=1)
    out = _rwkv_out(y, g[:, 0], p, sp, xin.dtype)[:, None]
    return out, RWKVState(wkv=wkv, last=_wide(xin[:, 0]))


class ChannelMix(nn.Module):
    def __init__(self, d: int, f: int, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.mu = full((2, d), 0.5, device)
        self.wk = normal(gen, (d, f), dtype, 1.0 / math.sqrt(d), device)
        self.wv = normal(gen, (f, d), dtype, 1.0 / math.sqrt(f), device)


def rwkv_channelmix(x: torch.Tensor, xprev: torch.Tensor, p) -> torch.Tensor:
    """relu(xk @ wk)² @ wv (``layers.mlp``: on a mesh the rank's columns of
    ``wk`` and rows of ``wv``, summed over ``model``)."""
    mu = p.mu.to(x.dtype)
    xk = xprev + mu[0] * (x - xprev)
    return mlp(xk, p, "relu2", up="wk", down="wv")
