"""Shared neural layers (port of :mod:`repro.models.layers`).

RMSNorm, RoPE, blockwise attention, gated MLP, embedding, and the
training loss.  Weights keep the reference's ``(d_in, d_out)`` layout.
Attention streams KV in chunks with a running softmax like the
reference; when gradients are needed it runs through the reference's
flash-style backward (:class:`_BlockwiseAttention`: the forward saves
only the output and the log-sum-exp, the backward recomputes the
probability blocks chunk by chunk).  The reference leaves this attention
to XLA (outside any Pallas kernel), so plain PyTorch is its counterpart
here.

Row invariance.  A matrix product or a row reduction in PyTorch may take
a different kernel, and so a different summation order, for a different
number of rows.  The serving paths must not: a request served in a
batch of slots, chunk by chunk, has to give the bits it gives alone.  So
every row-wise stage (norm, projections, MLP, output head) of a serving
path runs through :func:`row_blocked`, on blocks of exactly
:data:`ROW_BLOCK` rows, and :func:`ring_attention` computes each query
row with operations of one fixed shape per (row block, ring length).
Training has no such invariant: its forward uses whole-tensor products,
as the reference's ``einsum``s are.
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
    """Blockwise multi-head attention with GQA and a flash-style backward.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D).  q_positions (B, Sq),
    k_positions (B, Sk); kv_valid (B, Sk) bool masks out entries.  When
    q, k or v requires grad (and grad mode is on), the call goes through
    :class:`_BlockwiseAttention`, which saves only (out, logsumexp) and
    recomputes the probability blocks in the backward pass."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    if kv_valid is None:
        kv_valid = torch.ones((b, sk), dtype=torch.bool, device=q.device)
    cfg = (bool(causal), int(window), int(min(q_chunk, sq)),
           int(min(kv_chunk, sk)), float(scale))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _BlockwiseAttention.apply(cfg, q, k, v, q_positions,
                                         k_positions, kv_valid)
    return _attention_fwd(cfg, q, k, v, q_positions, k_positions,
                          kv_valid, with_lse=False)[0]


def _attention_fwd(cfg, q, k, v, q_positions, k_positions, kv_valid,
                   with_lse=True):
    """(out (B, Sq, H, Dv) in v's dtype, logsumexp (B, Sq, K, G) float32,
    or None without ``with_lse``: the serving paths skip its ops).  Rows
    with no unmasked key get logsumexp 1e30, so the backward's recomputed
    probabilities are 0 for them (as in the reference)."""
    causal, window, q_chunk, kv_chunk, scale = cfg
    b, sq, h, d = q.shape
    _, sk, kh, _ = k.shape
    g = h // kh
    dv = v.shape[-1]
    qs = (q.float() * scale).reshape(b, sq, kh, g, d)
    outs, lses = [], []
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
        if with_lse:
            lses.append(torch.where(l > 0, m + torch.log(torch.clamp_min(
                l, 1e-30)), torch.full_like(l, 1e30)))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    lse = (torch.cat(lses, dim=1) if len(lses) > 1 else lses[0]) \
        if with_lse else None
    return out.reshape(b, sq, h, dv).to(v.dtype), lse


class _BlockwiseAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` attention (``_attn_fwd`` /
    ``_attn_bwd``): the forward keeps (out, logsumexp); the backward walks
    KV chunks, and inside each the query chunks, recomputing each
    probability block from the saved logsumexp."""

    @staticmethod
    def forward(ctx, cfg, q, k, v, q_positions, k_positions, kv_valid):
        out, lse = _attention_fwd(cfg, q, k, v, q_positions, k_positions,
                                  kv_valid)
        ctx.cfg = cfg
        ctx.save_for_backward(q, k, v, q_positions, k_positions, kv_valid,
                              out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, window, q_chunk, kv_chunk, scale = ctx.cfg
        q, k, v, q_positions, k_positions, kv_valid, out, lse = \
            ctx.saved_tensors
        b, sq, h, d = q.shape
        _, sk, kh, _ = k.shape
        g = h // kh
        dv = v.shape[-1]
        dog = dout.reshape(b, sq, kh, g, dv).float()
        og = out.reshape(b, sq, kh, g, dv).float()
        dvec = (dog * og).sum(dim=-1)                  # (B, Sq, K, G)
        qs = (q.float() * scale).reshape(b, sq, kh, g, d)
        dq = torch.zeros((b, sq, kh, g, d), dtype=torch.float32,
                         device=q.device)
        dks, dvs = [], []
        for k0 in range(0, sk, kv_chunk):
            k_c = k[:, k0:k0 + kv_chunk].float()
            v_c = v[:, k0:k0 + kv_chunk].float()
            kp_c = k_positions[:, k0:k0 + kv_chunk]
            invalid = ~kv_valid[:, None, None, None, k0:k0 + kv_chunk]
            dk_c = torch.zeros_like(k_c)
            dv_c = torch.zeros_like(v_c)
            for q0 in range(0, sq, q_chunk):
                q_blk = qs[:, q0:q0 + q_chunk]
                do_blk = dog[:, q0:q0 + q_chunk]
                s = torch.einsum("bqkgd,bckd->bqkgc", q_blk, k_c)
                mask = _chunk_mask(q_positions[:, q0:q0 + q_chunk], kp_c,
                                   causal, window)
                s = (s + mask[:, :, None, None, :]).masked_fill(invalid,
                                                               NEG_INF)
                p = torch.exp(s - lse[:, q0:q0 + q_chunk, ..., None])
                dv_c += torch.einsum("bqkgc,bqkgd->bckd", p, do_blk)
                dp = torch.einsum("bqkgd,bckd->bqkgc", do_blk, v_c)
                ds = p * (dp - dvec[:, q0:q0 + q_chunk, ..., None])
                dq[:, q0:q0 + q_chunk] += torch.einsum(
                    "bqkgc,bckd->bqkgd", ds, k_c) * scale
                dk_c += torch.einsum("bqkgc,bqkgd->bckd", ds, q_blk)
            dks.append(dk_c)
            dvs.append(dv_c)
        dk = torch.cat(dks, dim=1) if len(dks) > 1 else dks[0]
        dv_out = torch.cat(dvs, dim=1) if len(dvs) > 1 else dvs[0]
        return (None, dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
                dv_out.to(v.dtype), None, None, None)


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
    """Output head of the serving paths: (B, S, D) x (V, D)^T -> (B, S, V)
    float32 logits, row-blocked."""
    if x.dtype == torch.float32:
        return row_blocked(lambda xb: xb @ table.t(), x)
    return row_blocked(lambda xb: F.linear(xb, table).float(), x)


def softmax_xent(logits, labels, mask=None):
    """Token-mean cross-entropy; logits (B, S, V) float32, labels (B, S),
    mask (B, S) or None."""
    nll = (torch.logsumexp(logits, dim=-1)
           - logits.gather(-1, labels.long()[..., None])[..., 0])
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def lm_head_loss(x, table, labels, mask=None):
    """Output head and cross-entropy of the training path: whole-tensor
    logits (a bf16 model's product is made in bf16, then widened to
    float32, as the serving head's is)."""
    return softmax_xent(F.linear(x, table).float(), labels, mask)
