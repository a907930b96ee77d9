"""Dense GQA transformer family (port of :mod:`repro.models.dense`).

One layer kind ("global"/"local" differ only in the sliding-window mask
and cache length), period-stacked via :mod:`repro_torch.models.stack`.
Caches are ring buffers written in place.  Single device: there is no
``dist`` argument.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.models import cache as C
from repro_torch.models import layers as L
from repro_torch.models import stack as S
from repro_torch.models.base import ArchConfig, ParamSpec


def attn_mlp_specs(cfg: ArchConfig, kind: str) -> Dict[str, ParamSpec]:
    d, dt = cfg.d_model, cfg.dtype
    out = {
        "ln1": ParamSpec((d,), (None,), dt, "zeros"),
        "wq": ParamSpec((d, cfg.q_dim), ("embed", "heads"), dt),
        "wk": ParamSpec((d, cfg.kv_dim), ("embed", "kv"), dt),
        "wv": ParamSpec((d, cfg.kv_dim), ("embed", "kv"), dt),
        "wo": ParamSpec((cfg.q_dim, d), ("heads", "embed"), dt),
        "ln2": ParamSpec((d,), (None,), dt, "zeros"),
        "wg": ParamSpec((d, cfg.d_ff), ("embed", "mlp"), dt),
        "wu": ParamSpec((d, cfg.d_ff), ("embed", "mlp"), dt),
        "wd": ParamSpec((cfg.d_ff, d), ("mlp", "embed"), dt),
    }
    return out


def mlp_apply(cfg: ArchConfig, p, h):
    return L.gated_mlp(h, p["wg"], p["wu"], p["wd"])


def cache_len(cfg: ArchConfig, kind: str, max_len: int) -> int:
    if kind == "local" and cfg.window > 0:
        return min(cfg.window, max_len)
    return max_len


def attn_cache_specs(cfg: ArchConfig, kind: str, batch: int,
                     max_len: int) -> Dict[str, ParamSpec]:
    ln = cache_len(cfg, kind, max_len)
    kv = (batch, ln, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    return {
        "k": ParamSpec(kv, axes, cfg.dtype, "zeros"),
        "v": ParamSpec(kv, axes, cfg.dtype, "zeros"),
        "pos": ParamSpec((batch, ln), ("batch", "cache_seq"), torch.int32,
                         "zeros"),
    }


def _qkv(cfg, p, h, positions):
    b, s, _ = h.shape
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_mlp_apply(cfg: ArchConfig, kind: str, p, x, cache, positions,
                   mode: str, pos=None, fault_ctx=None, slot_ref=None):
    """One transformer block.  mode: prefill | decode.

    ``fault_ctx`` (decode only): a read-path context
    (:mod:`repro_torch.serving.readpath`); when it covers this slot, the
    ctx owns the ring write and the fused faulty attention over it.
    ``slot_ref`` is the ``(slot key, period index)`` pair from the stack."""
    window = cfg.window if kind == "local" else 0
    causal = kind != "enc"
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, positions)
    if mode == "prefill":
        C.ring_fill(cache, {"k": k, "v": v}, positions)
        out = L.attention(q, k, v, q_positions=positions,
                          k_positions=positions, causal=causal,
                          window=window)
    elif mode == "decode":
        covered = (fault_ctx is not None and slot_ref is not None
                   and fault_ctx.covers(slot_ref[0]))
        if covered:
            fault_ctx.update(slot_ref[0], cache, {"k": k, "v": v}, pos)
            out = fault_ctx.attend(slot_ref[0], slot_ref[1], q, cache,
                                   q_pos=pos, causal=causal, window=window)
        else:
            C.ring_write(cache, {"k": k, "v": v}, pos)
            out = L.attention(q, cache["k"], cache["v"],
                              q_positions=positions,
                              k_positions=cache["pos"], causal=causal,
                              window=window, kv_valid=cache["pos"] >= 0)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    b, s, _, _ = out.shape
    x = x + out.reshape(b, s, -1) @ p["wo"]
    h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(cfg, p, h2), cache


def layout(cfg: ArchConfig) -> S.PeriodLayout:
    period = len(cfg.pattern) if cfg.pattern else 1
    return S.layout_from_kinds(cfg.layer_kinds(), period)


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), (None, "embed"),
                           cfg.dtype),
        "unembed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                             cfg.dtype),
        "stack": S.stack_specs(layout(cfg),
                               functools.partial(attn_mlp_specs, cfg)),
        "ln_f": ParamSpec((cfg.d_model,), (None,), cfg.dtype, "zeros"),
    }


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    return S.stack_cache_specs(
        layout(cfg), lambda kind: attn_cache_specs(cfg, kind, batch, max_len))


def _run_stack(cfg, params, x, positions, cache, mode, pos=None,
               fault_ctx=None):
    if fault_ctx is None:
        apply_slot = lambda kind, p, xx, c: attn_mlp_apply(  # noqa: E731
            cfg, kind, p, xx, c, positions, mode, pos)
    else:
        apply_slot = lambda kind, p, xx, c, ref: attn_mlp_apply(  # noqa: E731
            cfg, kind, p, xx, c, positions, mode, pos, fault_ctx=fault_ctx,
            slot_ref=ref)
    x, cache = S.apply_stack(params["stack"], x, layout(cfg), apply_slot,
                             cache=cache,
                             with_slot_ref=fault_ctx is not None)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), cache


@torch.no_grad()
def prefill(params, batch, cfg: ArchConfig, max_len: int):
    """Exact (unpadded) prefill: returns (last-token logits (B, V) f32,
    the filled cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32,
                             device=dev).expand(b, s)
    cache = C.init_cache(cache_specs(cfg, b, max_len), dev)
    x = L.embed(tokens, params["embed"])
    x, cache = _run_stack(cfg, params, x, positions, cache, "prefill")
    logits = L.unembed(x[:, -1:], params["unembed"])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, cache, batch, pos: int, cfg: ArchConfig,
                fault_ctx=None):
    """batch["tokens"]: (B, 1) at absolute position ``pos``; returns
    ((B, V) f32 logits, cache) with the cache written in place."""
    tokens = batch["tokens"]
    b, c = tokens.shape
    positions = C.decode_positions(pos, b, c, tokens.device)
    x = L.embed(tokens, params["embed"])
    x, cache = _run_stack(cfg, params, x, positions, cache, "decode",
                          pos=pos, fault_ctx=fault_ctx)
    logits = L.unembed(x, params["unembed"])
    return logits[:, 0], cache


# The serving engine's fused read-path injection understands this family's
# cache layout (ring k/v/pos leaves, slot axis "cache_seq").
SUPPORTS_READ_PATH = True
