"""Plain PyTorch version of the prefill flash-attention kernel K7
(port of :mod:`repro.kernels.flash_attention.ref`): materialized-softmax
attention with causal/window masks and GQA, float32 internals."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale=None):
    """q: (B, H, Sq, D); k, v: (B, K, Sk, D); returns (B, H, Sq, D) in
    v's dtype.  Query row i and key j sit at positions i and j."""
    b, h, sq, d = q.shape
    _, kh, sk, _ = k.shape
    g = h // kh
    scale = d ** -0.5 if scale is None else scale
    k_rep = k.repeat_interleave(g, dim=1)
    v_rep = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k_rep.float())
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(sk, device=q.device)[None, :]
    delta = qi - ki
    mask = torch.zeros((sq, sk), dtype=torch.float32, device=q.device)
    if causal:
        mask = mask.masked_fill(delta < 0, NEG_INF)
    if window > 0:
        mask = mask.masked_fill(delta >= window, NEG_INF)
    s = s + mask
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, v_rep.float()).to(v.dtype)
