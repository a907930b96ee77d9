"""Public wrapper of the prefill flash-attention kernel K7: padding and
dispatch (port of :mod:`repro.kernels.flash_attention.ops`)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.kernels.flash_attention.flash_attention import (
    TILES, flash_attention_fwd, pick_variant)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale=None, use_ref: bool = False):
    """q: (B, H, S, D); k, v: (B, K, S, D).  Returns (B, H, S, D) in v's
    dtype.

    CPU tensors (and ``use_ref``) take the plain version
    :func:`~repro_torch.kernels.flash_attention.ref.attention_ref`, as
    ``meta`` tensors do (the dry run's trace, which computes nothing); CUDA
    tensors launch K7 once, in the variant :func:`pick_variant` names for
    their dtype and head_dim, after padding q to whole query tiles and k/v
    to whole key tiles of that variant as the reference wrapper pads to its
    blocks (the kernel masks the padded keys), and the output is cut back
    to S rows."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = float(d ** -0.5 if scale is None else scale)
    if use_ref or q.device.type in ("cpu", "meta"):
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  scale=scale)
    variant = pick_variant(q.dtype, d)
    tiles = TILES[variant]
    pad_q = (-sq) % tiles.bq
    pad_k = (-sk) % tiles.bkv
    q = F.pad(q, (0, 0, 0, pad_q)) if pad_q else q.contiguous()
    k = F.pad(k, (0, 0, 0, pad_k)) if pad_k else k.contiguous()
    v = F.pad(v, (0, 0, 0, pad_k)) if pad_k else v.contiguous()
    out = flash_attention_fwd(q, k, v, sk=sk, causal=causal, window=window,
                              scale=scale, variant=variant)
    return out[:, :, :sq] if pad_q else out
