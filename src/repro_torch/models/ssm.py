"""State-space blocks (counterpart of ``repro/models/ssm.py``): Mamba2
(SSD, chunked) and RWKV6 (Finch, chunked WKV), with their one-token
decode steps against an explicit recurrent state.

Both prefill paths are the reference's chunked formulation: dense
einsums inside a chunk under a decay mask, and the state carried from
chunk to chunk by a loop (the reference's ``lax.scan``).  Decays are
accumulated in log space per chunk, in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import full, normal, rms_norm

CHUNK = 128


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


def mamba2(xin: torch.Tensor, p, cfg) -> torch.Tensor:
    """Prefill path, chunked SSD.  xin: (B, S, D)."""
    Bsz, S, D = xin.shape
    H = cfg.ssm_heads
    N = cfg.ssm_state
    di = 2 * D
    hd = di // H
    z = xin @ p.in_proj
    x, zgate, Bm, Cm, dt = _mamba_split(z, di, N, H)
    # causal depthwise conv over (x, B, C)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    k = p.conv.shape[0]
    pad = xbc.new_zeros((Bsz, k - 1, xbc.shape[-1]))
    xbc_p = torch.cat([pad, xbc], dim=1)
    conv = sum(xbc_p[:, i:i + S] * p.conv[i][None, None] for i in range(k))
    conv = F.silu(conv)
    x, Bm, Cm = torch.split(conv, [di, N, N], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias)                        # (B,S,H)
    A = -torch.exp(p.A_log)                                        # (H,)
    xh = x.reshape(Bsz, S, H, hd)
    y, _ = _ssd_chunked(xh, dt, A, Bm, Cm, chunk=min(CHUNK, S))
    y = y + xh * p.D.to(xh.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, di)
    y = rms_norm(y, p.norm) * F.silu(zgate.float()).to(y.dtype)
    return y @ p.out_proj


def _ssd_chunked(x, dt, A, B, C, chunk: int = CHUNK):
    """SSD: y_t = C_t · h_t,  h_t = exp(A·dt_t)·h_{t-1} + dt_t·B_t x_t.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); B,C: (B,S,N) (single group).
    Returns (y (B,S,H,P), final state (B,H,P,N))."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    nc = S // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = B.reshape(Bsz, nc, chunk, N).float()
    Cc = C.reshape(Bsz, nc, chunk, N).float()

    da = dtc * A[None, None, None, :]                  # (B,nc,c,H) ≤ 0
    cum = torch.cumsum(da, dim=2)                      # inclusive
    seg_sum = cum[:, :, -1:, :]                        # (B,nc,1,H)

    xdt = xc.float() * dtc[..., None]
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
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
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


def mamba2_decode(xin: torch.Tensor, p, cfg, state: MambaState):
    """One-token decode.  xin: (B, 1, D)."""
    Bsz, _, D = xin.shape
    H, N = cfg.ssm_heads, cfg.ssm_state
    di = 2 * D
    hd = di // H
    z = xin[:, 0] @ p.in_proj
    x, zgate, Bm, Cm, dt = _mamba_split(z, di, N, H)
    xbc = torch.cat([x, Bm, Cm], dim=-1)               # (B, convdim)
    hist = torch.cat([state.conv, xbc[:, None]], dim=1)    # (B,k,convdim)
    conv = torch.einsum("bkc,kc->bc", hist, p.conv)
    conv = F.silu(conv)
    x, Bm, Cm = torch.split(conv, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)            # (B,H)
    A = -torch.exp(p.A_log)
    xh = x.reshape(Bsz, H, hd).float()
    decay = torch.exp(dt * A[None])                    # (B,H)
    upd = torch.einsum("bhp,bf,bh->bhpf", xh, Bm.float(), dt)
    ssm = state.ssm * decay[..., None, None] + upd
    y = torch.einsum("bf,bhpf->bhp", Cm.float(), ssm)
    y = y + xh * p.D[None, :, None]
    y = y.reshape(Bsz, di)
    y = rms_norm(y, p.norm) * F.silu(zgate.float()).to(y.dtype)
    out = (y.to(xin.dtype) @ p.out_proj)[:, None]
    return out, MambaState(ssm=ssm, conv=hist[:, 1:])


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


def _rwkv_proj(x, xprev, p):
    """Token-shift mixing + projections.  x: (B,S,D); xprev: shifted x."""
    mu = p.mu.to(x.dtype)
    xs = [xprev + mu[i][None, None] * (x - xprev) for i in range(5)]
    r = xs[0] @ p.wr
    k = xs[1] @ p.wk
    v = xs[2] @ p.wv
    lw = p.w0 + torch.tanh(xs[3].float() @ p.wA.float()) @ p.wB.float()
    logw = -torch.exp(lw)                               # log decay ≤ 0
    g = F.silu(xs[4] @ p.wg)
    return r, k, v, logw, g


def rwkv6(xin: torch.Tensor, p, cfg) -> torch.Tensor:
    """Chunked WKV.  xin: (B, S, D)."""
    B, S, D = xin.shape
    H = cfg.n_heads
    hd = D // H
    xprev = torch.cat([torch.zeros_like(xin[:, :1]), xin[:, :-1]], dim=1)
    r, k, v, logw, g = _rwkv_proj(xin, xprev, p)
    rh = r.reshape(B, S, H, hd).float()
    kh = k.reshape(B, S, H, hd).float()
    vh = v.reshape(B, S, H, hd).float()
    lw = logw.reshape(B, S, H, hd)
    y = _wkv_chunked(rh, kh, vh, lw, p.u, chunk=min(CHUNK, S))
    y = y.reshape(B, S, D)
    y = rms_norm(y.to(xin.dtype), p.ln_x) * g
    return y @ p.wo


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

    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    prev = []                                           # the state before
    for n in range(nc):                                 # each chunk
        prev.append(state)
        state = state * segd[:, n, ..., None] + G[:, n]
    Sprev = torch.stack(prev, dim=1)                    # (B,nc,H,K,V)
    y_inter = torch.einsum("bnihk,bnhkv->bnihv", rc * torch.exp(cum_ex),
                           Sprev)
    return (y_intra + y_inter).reshape(B, S, H, K)


def rwkv6_decode(xin: torch.Tensor, p, cfg, state: RWKVState):
    B, _, D = xin.shape
    H = cfg.n_heads
    hd = D // H
    xprev = state.last[:, None].to(xin.dtype)
    r, k, v, logw, g = _rwkv_proj(xin, xprev, p)
    rh = r.reshape(B, H, hd).float()
    kh = k.reshape(B, H, hd).float()
    vh = v.reshape(B, H, hd).float()
    w = torch.exp(logw.reshape(B, H, hd))
    y = torch.einsum("bhk,bhkv->bhv", rh, state.wkv) \
        + torch.einsum("bhk,hk,bhk,bhv->bhv", rh, p.u, kh, vh)
    wkv = state.wkv * w[..., None] + torch.einsum("bhk,bhv->bhkv", kh, vh)
    y = y.reshape(B, D)
    y = rms_norm(y.to(xin.dtype), p.ln_x) * g[:, 0]
    out = (y @ p.wo)[:, None]
    return out, RWKVState(wkv=wkv, last=xin[:, 0].float())


class ChannelMix(nn.Module):
    def __init__(self, d: int, f: int, dtype, device,
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.mu = full((2, d), 0.5, device)
        self.wk = normal(gen, (d, f), dtype, 1.0 / math.sqrt(d), device)
        self.wv = normal(gen, (f, d), dtype, 1.0 / math.sqrt(f), device)


def rwkv_channelmix(x: torch.Tensor, xprev: torch.Tensor, p) -> torch.Tensor:
    mu = p.mu.to(x.dtype)
    xk = xprev + mu[0] * (x - xprev)
    h = F.relu(xk @ p.wk).square()
    return h @ p.wv
