"""Dense GQA transformer family (port of :mod:`repro.models.dense`).

One layer kind ("global"/"local" differ only in the sliding-window mask
and cache length), period-stacked via :mod:`repro_torch.models.stack`.
Caches are ring buffers written in place.  Single device: there is no
``dist`` argument.  The serving paths run row-wise stages through
:func:`layers.row_blocked`; the training path (:func:`forward_train`,
:func:`train_block`) uses whole-tensor products, as the reference's
``einsum``s are.
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


def _qkv(cfg, p, x, positions):
    """RMSNorm and the q/k/v projections (row-blocked), then RoPE."""
    b, s, _ = x.shape

    def proj(xb):
        h = L.rms_norm(xb, p["ln1"], cfg.norm_eps)
        return h @ p["wq"], h @ p["wk"], h @ p["wv"]

    q, k, v = L.row_blocked(proj, x)
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_mlp_apply(cfg: ArchConfig, kind: str, p, x, cache, positions,
                   mode: str, pos=None, fault_ctx=None, slot_ref=None,
                   prefill_attn=None, decode_attn=None):
    """One transformer block.  mode: prefill | decode.

    ``fault_ctx`` (decode only): a read-path context
    (:mod:`repro_torch.serving.readpath`) or a paged serving context
    (:mod:`repro_torch.serving.paged`); when it covers this slot, the ctx
    owns the cache write and the fused faulty attention over it.
    ``slot_ref`` is the ``(slot key, period index)`` pair from the stack.

    A prompt that fits its ring is attended over the filled ring
    (:func:`layers.ring_attention`), so exact prefill computes each row
    as chunked prefill over the same ring does.  Families that share this
    block may pass their own attention: ``prefill_attn(q, k, v, *,
    causal, window)`` over the whole prompt in (B, H, S, D) layout at
    positions 0..S-1 (the hybrid family's K7), and ``decode_attn`` with
    the signature of :func:`layers.ring_attention` over the ring."""
    window = cfg.window if kind == "local" else 0
    causal = kind != "enc"
    q, k, v = _qkv(cfg, p, x, positions)
    if mode == "prefill" and prefill_attn is not None:
        C.ring_fill(cache, {"k": k, "v": v}, positions)
        out = prefill_attn(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal=causal,
                           window=window).transpose(1, 2)
    elif mode == "prefill":
        C.ring_fill(cache, {"k": k, "v": v}, positions)
        if q.shape[1] <= cache["pos"].shape[1]:
            out = L.ring_attention(q, cache["k"], cache["v"],
                                   q_positions=positions,
                                   k_positions=cache["pos"],
                                   kv_valid=cache["pos"] >= 0,
                                   causal=causal, window=window)
        else:
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
            out = (L.attention if decode_attn is None else decode_attn)(
                q, cache["k"], cache["v"], q_positions=positions,
                k_positions=cache["pos"], causal=causal, window=window,
                kv_valid=cache["pos"] >= 0)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    b, s, _, _ = out.shape
    x = x + L.row_blocked(lambda ob: ob @ p["wo"], out.reshape(b, s, -1))
    return x + L.row_blocked(lambda xb: mlp_apply(
        cfg, p, L.rms_norm(xb, p["ln2"], cfg.norm_eps)), x), cache


def train_block(cfg: ArchConfig, kind: str, p, x, positions):
    """One transformer block of the training path (the reference's
    ``attn_mlp_apply`` in mode "train"): whole-tensor projections and the
    attention with its flash-style backward."""
    window = cfg.window if kind == "local" else 0
    b, s, _ = x.shape
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    out = L.attention(q, k, v, q_positions=positions, k_positions=positions,
                      causal=kind != "enc", window=window)
    x = x + out.reshape(b, s, -1) @ p["wo"]
    return x + mlp_apply(cfg, p, L.rms_norm(x, p["ln2"], cfg.norm_eps))


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
    return L.row_blocked(lambda xb: L.rms_norm(xb, params["ln_f"],
                                               cfg.norm_eps), x), cache


def forward_train(params, batch, cfg: ArchConfig):
    """Token-mean next-token loss of ``batch["tokens"]`` (B, S) (masked by
    ``batch["loss_mask"]`` (B, S - 1) if given); returns (loss, {"loss":
    loss}), differentiable in ``params``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = L.embed(tokens, params["embed"])
    x, _ = S.apply_stack(
        params["stack"], x, layout(cfg),
        lambda kind, p, xx, c: (train_block(cfg, kind, p, xx, positions), c),
        remat=cfg.remat == "block")
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    loss = L.lm_head_loss(x[:, :-1], params["unembed"], tokens[:, 1:],
                          batch.get("loss_mask"))
    return loss, {"loss": loss}


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
def decode_step(params, cache, batch, pos, cfg: ArchConfig, fault_ctx=None,
                logit_cols=None):
    """batch["tokens"]: (B, C); ``pos``: a scalar absolute position (C=1,
    returns (B, V) logits), a (B,) per-row position tensor (rows with a
    negative position skip their ring write) or a (B, C) per-token
    position tensor (the mixed prefill-chunk/decode serving step, returns
    (B, C, V) logits).  ``logit_cols`` (B,) picks one column per row
    before the output head and returns (B, V) logits.  The cache is
    written in place."""
    tokens = batch["tokens"]
    b, c = tokens.shape
    positions = C.decode_positions(pos, b, c, tokens.device)
    x = L.embed(tokens, params["embed"])
    x, cache = _run_stack(cfg, params, x, positions, cache, "decode",
                          pos=pos, fault_ctx=fault_ctx)
    if logit_cols is not None:
        x = x[torch.arange(b, device=x.device), logit_cols.long()][:, None]
        c = 1
    logits = L.unembed(x, params["unembed"])
    return (logits[:, 0] if c == 1 else logits), cache


# The serving engine's fused read-path injection understands this family's
# cache layout (ring k/v/pos leaves, slot axis "cache_seq").
SUPPORTS_READ_PATH = True
# The continuous-batching scheduler can page this family's cache: the
# decode step threads a paged ctx through attn_mlp_apply (per-slot and
# per-token positions, pool-page writes, batched paged attention).
SUPPORTS_PAGED = True
