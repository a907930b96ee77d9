"""The comparison that decides ``correct`` for a served model.

Once the window has closed, a sample of the requests the run finished,
drawn from the seed with the longest among them, is run through the
plain reference, prompt and served tokens together.  The number compared
is the widest gap by which a served token's logit lies below the
reference's best logit at that position (greedy decoding serves the best
token, so a sound program reads only its rounding).  A non-finite gap
counts as infinite.

The control puts the reference itself in the program's place at the next
precision below the configuration's bfloat16 weights: float8 (e4m3)
weights with one scale a tensor.  It reads the gap of the token that the
control ranks first, at every position of the same prompts and tokens.
"""
from __future__ import annotations

import random
from typing import List, Sequence

import torch

from hbm_bench.weights import sub_seed


def pick_sample(finished: Sequence[dict], seed: int, tokens: int,
                most: int) -> List[dict]:
    """The longest finished request, then others drawn from the seed,
    until the sample holds ``tokens`` served tokens or ``most``
    requests."""
    if not finished:
        return []
    by_len = sorted(finished, key=lambda r: (-len(r["served"]), r["rid"]))
    out = [by_len[0]]
    rest = sorted(by_len[1:], key=lambda r: r["rid"])
    random.Random(sub_seed(seed, "sample")).shuffle(rest)
    for r in rest:
        if sum(len(x["served"]) for x in out) >= tokens or len(out) >= most:
            break
        out.append(r)
    return out


def gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per position: best logit minus the chosen token's (inf where the
    row is not finite)."""
    best = logits.max(dim=-1).values
    got = logits.gather(1, chosen.long()[:, None])[:, 0]
    g = best - got
    ok = torch.isfinite(logits).all(dim=-1)
    return torch.where(ok, g, torch.full_like(g, float("inf")))


def fp8_weights(w: torch.Tensor) -> torch.Tensor:
    """A bfloat16 weight rounded to float8 e4m3 with one scale a tensor
    (the largest magnitude maps to e4m3's 448), back in float32."""
    w = w.float()
    scale = w.abs().max().clamp_min(1e-30) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale
