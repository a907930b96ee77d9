"""Model weights drawn on the device from the run's seed.

Each layer is one ``torch.randn`` call into one flat bfloat16 buffer,
sliced into the layer's matrices in a fixed order and scaled by
``1 / sqrt(fan_in)`` (the width each contracts) in place; the embedding
and the output head are one call each.  Every call has its own generator, seeded from (run seed,
tensor name), so the reference can draw any one layer again, alone, on
the same device and get the same bits.  Norm gains are zeros: the
program and the reference both apply ``1 + gain``.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

DTYPE = torch.bfloat16


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit generator seed from the run seed and a tag."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


Shape = Tuple[int, ...]


def dense_layer_shapes(cfg: dict) -> List[Tuple[str, Shape, int]]:
    """The matrices of one dense GQA layer, (d_in, d_out) each, with the
    width each contracts."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    ff = cfg["intermediate_size"]
    return [("wq", (d, q), d), ("wk", (d, kv), d), ("wv", (d, kv), d),
            ("wo", (q, d), q), ("wg", (d, ff), d), ("wu", (d, ff), d),
            ("wd", (ff, d), ff)]


def _draw(seed: int, tag, shapes, device) -> Dict[str, torch.Tensor]:
    n = sum(math.prod(s) for _, s, _ in shapes)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    flat = torch.randn(n, generator=g, dtype=DTYPE, device=device)
    out, at = {}, 0
    for name, shape, fan_in in shapes:
        w = flat[at:at + math.prod(shape)].view(shape)
        w.mul_(1.0 / math.sqrt(fan_in))
        out[name] = w
        at += math.prod(shape)
    return out


def layer(cfg: dict, seed: int, index: int, device):
    """Layer ``index``'s matrices, bfloat16, on ``device``."""
    return _draw(seed, ("layer", index), dense_layer_shapes(cfg), device)


def dense_head(cfg: dict, seed: int, which: str, device) -> torch.Tensor:
    """The embedding table (unit normal rows) or the output head
    (``1 / sqrt(d)``), both (vocab, d)."""
    v, d = cfg["vocab_size"], cfg["hidden_size"]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, which))
    w = torch.randn((v, d), generator=g, dtype=DTYPE, device=device)
    return w if which == "embed" else w.mul_(1.0 / math.sqrt(d))
