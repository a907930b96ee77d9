"""Plain float32 forward pass of a dense GQA decoder (Llama / Yi layout)
served from an undervolted, SECDED-protected paged KV cache.

The published architecture: RMSNorm before attention and MLP, rotary
embeddings on the two halves of each head (``rotate_half``), grouped-
query attention, a SwiGLU MLP, a final RMSNorm and an untied output head.
Weights are drawn again from the run's seed, one layer at a time
(:mod:`hbm_bench.weights`), and used at float32 with TF32 off; the cache
holds K and V in bfloat16, as the configuration states.

What the served request saw of its cache: prompt positions attend the
cache as written (chunked prefill reads the pages clean); the query at a
decoded position ``t`` reads every earlier position through the SECDED
round of the physical words that hold it (reference/faults.py) and its
own position as written.  The physical words follow from the request's
pages, the pool's shape and the domain's placement, all worked out here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

import torch

from hbm_bench import weights as W
from hbm_bench.reference import faults as F


@dataclasses.dataclass(frozen=True)
class PagedKV:
    """Where one request's K/V live: its pages in a pool of
    ``total_pages`` pages of ``page_slots`` positions, the pool's leaves
    placed in a SECDED domain at ``voltage`` over ``pcs``."""

    page_ids: Sequence[int]
    total_pages: int
    page_slots: int
    max_len: int
    map_seed: int
    voltage: float
    pcs: Sequence[int]


def pool_leaves(cfg: dict, total_pages: int, page_slots: int):
    """(path, words) of the pool's K, V and position leaves, the layers
    stacked in front: the layout the domain places."""
    layers = cfg["num_hidden_layers"]
    kv_words = cfg["num_key_value_heads"] * cfg["head_dim"] // 2
    slots = layers * total_pages * page_slots
    return [("['periods']['s0_global']['k']", slots * kv_words),
            ("['periods']['s0_global']['pos']", slots),
            ("['periods']['s0_global']['v']", slots * kv_words)]


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, heads, hd) at positions 0..T-1."""
    t, _, hd = x.shape
    half = hd // 2
    inv = (theta ** (-torch.arange(half, dtype=torch.float64) / half)
           ).float().to(x.device)
    ang = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _read_back(kv: torch.Tensor, which: str, layer: int, place: PagedKV,
               first_block: Dict[str, int], thr, fmap_seed: int):
    """The words a SECDED read returns for every position's K or V
    (``kv``: (T, kh, hd) bfloat16 as stored), and the uncorrectable
    codeword count among them."""
    t = kv.shape[0]
    words = kv.reshape(t, -1).contiguous().view(torch.int32).to(
        torch.int64) & F.MASK
    wps = words.shape[1]
    pos = torch.arange(t, device=kv.device)
    slot = pos % place.max_len
    pages = torch.as_tensor(list(place.page_ids), dtype=torch.int64,
                            device=kv.device)
    pid = pages[slot // place.page_slots]
    row = slot % place.page_slots
    off = (((layer * place.total_pages + pid) * place.page_slots + row)
           * wps)[:, None] + torch.arange(wps, device=kv.device)
    path = f"['periods']['s0_global']['{which}']"
    wid, pc = F.physical_words(first_block[path], off, place.pcs)
    out, bad = F.ecc_round(words, wid, thr, pc, fmap_seed)
    out = (out - ((out >> 31) << 32)).to(torch.int32)
    return out.view(torch.bfloat16).reshape(kv.shape), bad


def usable(cfg: dict, r: dict, device) -> bool:
    """Whether the reference can follow a served request: none of its
    position words (every page of its ring, every layer) lies in a
    codeword that a SECDED round can leave faulted.  The program rounds
    those words at every step, and a faulted position changes which keys
    attend; the reference reads positions as written.  At the cells'
    voltage such a codeword is rare (PERF.md gives the odds)."""
    return pos_weak_codewords(cfg, r["place"], r["place"].max_len,
                              device) == 0


def pos_weak_codewords(cfg: dict, place: PagedKV, positions: int,
                       device) -> int:
    """Codewords of the request's position words (the pages holding
    positions 0..positions-1, every layer) that a SECDED round can leave
    faulted."""
    fmap = F.FaultMap(place.map_seed)
    thr = {k: v.to(device) for k, v in fmap.thresholds(place.voltage).items()}
    first = F.bump_placement(pool_leaves(cfg, place.total_pages,
                                         place.page_slots), place.pcs)
    n_pages = -(-min(positions, place.max_len) // place.page_slots)
    pages = torch.as_tensor(list(place.page_ids)[:n_pages],
                            dtype=torch.int64, device=device)
    layer = torch.arange(cfg["num_hidden_layers"], device=device)
    off = ((layer[:, None, None] * place.total_pages + pages[None, :, None])
           * place.page_slots + torch.arange(place.page_slots,
                                             device=device))
    wid, pc = F.physical_words(first["['periods']['s0_global']['pos']"],
                               off, place.pcs)
    return F.weak_codewords(wid, thr, pc, place.map_seed)


def forward(cfg: dict, seed: int, tokens: torch.Tensor, plen: int,
            place: Optional[PagedKV], *,
            cast: Callable[[torch.Tensor], torch.Tensor] = None):
    """Logits (float32) at positions ``plen - 1 .. T - 1`` of ``tokens``
    (T,), the prompt followed by the served tokens but the last, and the
    uncorrectable codeword count among the K/V words the decoded
    positions read.  ``place`` None: a cache that reads back as written.
    ``cast`` maps each bfloat16 weight before use (the control's lower
    precision); the default upcasts it exactly."""
    dev = tokens.device
    cast = cast or (lambda w: w.float())
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h, kh, hd = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    g = h // kh
    t = tokens.shape[0]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        emb = W.dense_head(cfg, seed, "embed", dev)
        x = cast(emb)[tokens.long()]
        del emb
        if place is not None:
            fmap = F.FaultMap(place.map_seed)
            thr = {k: v.to(dev)
                   for k, v in fmap.thresholds(place.voltage).items()}
            first = F.bump_placement(pool_leaves(cfg, place.total_pages,
                                                 place.page_slots),
                                     place.pcs)
        qpos = torch.arange(t, device=dev)
        causal = qpos[None, :] <= qpos[:, None]
        # keys a decoded query reads back through the SECDED round
        via_ecc = (qpos[:, None] >= plen) & (qpos[None, :] < qpos[:, None])
        scale = 1.0 / math.sqrt(hd)
        bad = 0
        for layer in range(cfg["num_hidden_layers"]):
            p = W.layer(cfg, seed, layer, dev)
            a = rms_norm(x, eps)
            q = rope((a @ cast(p["wq"])).reshape(t, h, hd), theta)
            k = rope((a @ cast(p["wk"])).reshape(t, kh, hd), theta)
            v = (a @ cast(p["wv"])).reshape(t, kh, hd)
            k_st, v_st = k.to(torch.bfloat16), v.to(torch.bfloat16)
            if place is not None:
                k_rd, nk = _read_back(k_st, "k", layer, place, first, thr,
                                      place.map_seed)
                v_rd, nv = _read_back(v_st, "v", layer, place, first, thr,
                                      place.map_seed)
                bad += nk + nv
            else:
                k_rd, v_rd = k_st, v_st
            out = torch.empty((t, h, hd), dtype=torch.float32, device=dev)
            for j in range(kh):
                qj = q[:, j * g:(j + 1) * g].transpose(0, 1) * scale
                kc, vc = k_st[:, j].float(), v_st[:, j].float()
                kr, vr = k_rd[:, j].float(), v_rd[:, j].float()
                s = torch.where(via_ecc, qj @ kr.t(), qj @ kc.t())
                s = s.masked_fill(~causal, float("-inf"))
                pr = torch.softmax(s, dim=-1)
                o = (torch.where(via_ecc, 0.0, pr) @ vc
                     + torch.where(via_ecc, pr, 0.0) @ vr)
                out[:, j * g:(j + 1) * g] = o.transpose(0, 1)
            x = x + out.reshape(t, h * hd) @ cast(p["wo"])
            a = rms_norm(x, eps)
            x = x + (torch.nn.functional.silu(a @ cast(p["wg"]))
                     * (a @ cast(p["wu"]))) @ cast(p["wd"])
            del p
        head = W.dense_head(cfg, seed, "unembed", dev)
        logits = rms_norm(x[plen - 1:], eps) @ cast(head).t()
        return logits, bad
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]


def check(cfg: dict, seed: int, sample, device, control: bool = False):
    """The numbers compared for a sample of served requests: the widest
    logit gap of a served token, with what was read to get it.  With
    ``control`` the float8 control takes the program's place: the number
    is the widest gap of the token the control ranks first, at every
    position of the same prompts and served tokens, and the program's
    own reading goes to the information beside it."""
    from hbm_bench.reference.compare import fp8_weights, gaps
    worst, worst_ctl, tokens, bad = 0.0, 0.0, 0, 0
    for r in sample:
        served = torch.as_tensor(r["served"], device=device)
        prompt = torch.as_tensor(r["prompt"], device=device).long()
        seq = torch.cat([prompt, served[:-1].long()])
        logits, n_bad = forward(cfg, seed, seq, len(prompt), r["place"])
        bad += n_bad
        tokens += len(served)
        worst = max(worst, float(gaps(logits, served).max()))
        if control:
            low, _ = forward(cfg, seed, seq, len(prompt), r["place"],
                             cast=fp8_weights)
            worst_ctl = max(worst_ctl, float(
                gaps(logits, low.argmax(dim=-1)).max()))
            del low
        del logits
    info = {"requests": len(sample), "tokens": tokens,
            "uncorrectable_kv_codewords": bad}
    if control:
        info["program_max_logit_gap"] = worst
        return {"max_logit_gap": worst_ctl}, info
    return {"max_logit_gap": worst}, info
