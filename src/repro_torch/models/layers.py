"""Shared neural layers (port of :mod:`repro.models.layers`, forward only).

RMSNorm, RoPE, blockwise attention, gated MLP, embedding.  Weights keep
the reference's ``(d_in, d_out)`` layout.  Attention streams KV in chunks
with a running softmax like the reference; the reference leaves this
attention to XLA (outside any Pallas kernel), so plain PyTorch is its
counterpart here.

Row invariance.  A matrix product or a row reduction in PyTorch may take
a different kernel, and so a different summation order, for a different
number of rows.  The serving paths must not: a request served in a
batch of slots, chunk by chunk, has to give the bits it gives alone.  So
every row-wise stage (norm, projections, MLP, output head) runs through
:func:`row_blocked`, on blocks of exactly :data:`ROW_BLOCK` rows, and
:func:`ring_attention` computes each query row with operations of one
fixed shape per (row block, ring length).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30
# Rows per block of every row-wise stage (see the module docstring).
ROW_BLOCK = 64


def row_blocked(fn, x):
    """``fn`` applied to the rows of ``x`` (..., d) in blocks of exactly
    ROW_BLOCK rows, the last block zero-padded, so that each row's result
    does not depend on how many rows there are.  ``fn`` maps an
    (ROW_BLOCK, d) tensor to a tensor or a tuple of tensors with
    ROW_BLOCK leading rows."""
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    n = x2.shape[0]
    pad = (-n) % ROW_BLOCK
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, x2.shape[1]))])
    outs = [fn(x2[i:i + ROW_BLOCK]) for i in range(0, n + pad, ROW_BLOCK)]
    single = isinstance(outs[0], torch.Tensor)
    if single:
        outs = [(o,) for o in outs]
    res = []
    for parts in zip(*outs):
        full = torch.cat(parts) if len(parts) > 1 else parts[0]
        res.append(full[:n].reshape(lead + tuple(full.shape[1:])))
    return res[0] if single else tuple(res)


def rms_norm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


@functools.lru_cache(maxsize=64)
def _rope_freq(theta: float, half: int, device: torch.device):
    """theta ** (-i / half) in float32, correctly rounded (as XLA's power
    is), computed once on the host and kept on ``device``."""
    expo = -torch.arange(0, half, dtype=torch.float32) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float64), expo.double())
    return freq.float().to(device)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding; x: (..., S, H, D), positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = _rope_freq(float(theta), half, x.device)
    angles = positions[..., :, None, None].float() * freq
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _chunk_mask(q_pos, k_pos, causal: bool, window: int):
    """(B, Sq, Sk) additive mask from absolute positions."""
    delta = q_pos[..., :, None] - k_pos[..., None, :]
    m = torch.zeros(delta.shape, dtype=torch.float32, device=delta.device)
    if causal:
        m = m.masked_fill(delta < 0, NEG_INF)
    if window > 0:
        m = m.masked_fill(delta >= window, NEG_INF)
    return m


def attention(q, k, v, *, q_positions, k_positions, causal: bool = True,
              window: int = 0, kv_valid: Optional[torch.Tensor] = None,
              q_chunk: int = 1024, kv_chunk: int = 1024,
              softmax_scale: Optional[float] = None):
    """Blockwise multi-head attention with GQA, forward only.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D).  q_positions (B, Sq),
    k_positions (B, Sk); kv_valid (B, Sk) bool masks out entries."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    dv = v.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if kv_valid is None:
        kv_valid = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, sk)
    qs = (q.float() * scale).reshape(b, sq, kh, g, d)
    outs = []
    for q0 in range(0, sq, q_chunk):
        q_blk = qs[:, q0:q0 + q_chunk]
        qpos = q_positions[:, q0:q0 + q_chunk]
        cq = q_blk.shape[1]
        acc = torch.zeros((b, cq, kh, g, dv), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, cq, kh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, cq, kh, g), dtype=torch.float32, device=q.device)
        for k0 in range(0, sk, kv_chunk):
            k_blk = k[:, k0:k0 + kv_chunk].float()
            v_blk = v[:, k0:k0 + kv_chunk].float()
            s = torch.einsum("bqkgd,bckd->bqkgc", q_blk, k_blk)
            mask = _chunk_mask(qpos, k_positions[:, k0:k0 + kv_chunk],
                               causal, window)
            s = s + mask[:, :, None, None, :]
            s = s.masked_fill(
                ~kv_valid[:, None, None, None, k0:k0 + kv_chunk], NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd",
                                                       p, v_blk)
            l = l * corr + p.sum(dim=-1)
            m = m_new
        outs.append(acc / torch.clamp_min(l[..., None], 1e-30))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(b, sq, h, dv).to(v.dtype)


def ring_attention(q, k, v, *, q_positions, k_positions, kv_valid,
                   causal: bool = True, window: int = 0,
                   softmax_scale: Optional[float] = None):
    """Attention of query rows over a whole ring of keys, row-invariant.

    q: (B, Sq, H, D); k, v: (B, Sk, KH, D) -- the ring, every slot
    present, with k_positions / kv_valid (B, Sk).  Each batch row's
    queries run in blocks of ROW_BLOCK rows (the last one padded) against
    all Sk keys, one softmax over the ring: the operations have one shape
    per (ROW_BLOCK, Sk), so a query row's bits depend only on its own
    position and keys, not on how many rows are computed with it.  Masked
    keys contribute exact zeros (their values must be finite)."""
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    dv = v.shape[-1]
    r = ROW_BLOCK
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, dv), dtype=v.dtype, device=q.device)
    for bi in range(b):
        kf = k[bi].float().permute(1, 2, 0).contiguous()     # (KH, D, Sk)
        vf = v[bi].float().permute(1, 0, 2).contiguous()     # (KH, Sk, D)
        kp = k_positions[bi]
        invalid = ~kv_valid[bi]
        for q0 in range(0, sq, r):
            n = min(r, sq - q0)
            qb = q[bi, q0:q0 + n].float()
            qpos = q_positions[bi, q0:q0 + n]
            if n < r:
                qb = torch.cat([qb, qb.new_zeros((r - n, h, d))])
                qpos = torch.cat([qpos, qpos.new_zeros(r - n)])
            qs = (qb * scale).reshape(r, kh, g, d).permute(1, 0, 2, 3)
            s = torch.bmm(qs.reshape(kh, r * g, d), kf).reshape(kh, r, g, sk)
            mask = _chunk_mask(qpos, kp, causal, window)         # (R, Sk)
            s = s + mask[None, :, None, :]
            s = s.masked_fill(invalid[None, None, None, :], NEG_INF)
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True)
            o = torch.bmm(p.reshape(kh, r * g, sk), vf).reshape(kh, r, g, dv)
            o = o / torch.clamp_min(l, 1e-30)
            out[bi, q0:q0 + n] = o.permute(1, 0, 2, 3).reshape(
                r, h, dv)[:n].to(v.dtype)
    return out


def gated_mlp(x, w_gate, w_up, w_down, act: str = "silu"):
    """SwiGLU/GeGLU MLP: down(act(x@gate) * (x@up))."""
    g = x @ w_gate
    u = x @ w_up
    a = F.silu(g) if act == "silu" else gelu(g)
    return (a * u).to(x.dtype) @ w_down


def gelu(x):
    """The tanh form of GELU, the default of the reference's
    ``jax.nn.gelu`` (approximate=True)."""
    return F.gelu(x, approximate="tanh")


def embed(tokens, table):
    return table[tokens]


def unembed(x, table):
    """Output head: (B, S, D) x (V, D)^T -> (B, S, V) float32 logits,
    row-blocked."""
    if x.dtype == torch.float32:
        return row_blocked(lambda xb: xb @ table.t(), x)
    return row_blocked(lambda xb: F.linear(xb, table).float(), x)
