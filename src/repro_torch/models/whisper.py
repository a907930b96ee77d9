"""Whisper family: bidirectional audio encoder + causal text decoder (port
of :mod:`repro.models.whisper`).

The conv frontend is a stub: ``batch["frames"]`` holds precomputed frame
embeddings (B, enc_len, d_model), the output of whisper's two conv
layers.  The encoder is ``enc_layers`` bidirectional blocks
(:func:`dense.train_block` with kind ``"enc"``); the decoder stacks
ring-cached self-attention, cross-attention to the encoder output (its
K/V written once at prefill into ``ck`` / ``cv``, layout ``"cross"``)
and plain-GELU MLPs (``cfg.mlp_gated`` False).  Rotary positions stand
in for whisper's learned embeddings, as in the reference.

The cross leaves have no ring-slot axis, so the serving write path
corrupts them whole every decode step (stuck-at masks are idempotent:
the bits stay those of one injection).  Row invariance: the decoder's
row-wise stages run through :func:`layers.row_blocked` and its self- and
cross-attention through :func:`layers.ring_attention`, so a state-arena
slot row equals the request decoded alone.  Training runs whole-tensor
products and :func:`layers.attention` with its flash-style backward.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.models import cache as C
from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.models import stack as S
from repro_torch.models.base import ArchConfig, ParamSpec


def dec_specs(cfg: ArchConfig, kind: str) -> Dict[str, ParamSpec]:
    d, dt = cfg.d_model, cfg.dtype
    out = dict(D.attn_mlp_specs(cfg, "global"))
    out.update({
        "ln_x": ParamSpec((d,), (None,), dt, "zeros"),
        "xq": ParamSpec((d, cfg.q_dim), ("embed", "heads"), dt),
        "xk": ParamSpec((d, cfg.kv_dim), ("embed", "kv"), dt),
        "xv": ParamSpec((d, cfg.kv_dim), ("embed", "kv"), dt),
        "xo": ParamSpec((cfg.q_dim, d), ("heads", "embed"), dt),
    })
    return out


def dec_cache_specs(cfg: ArchConfig, batch: int,
                    max_len: int) -> Dict[str, ParamSpec]:
    out = dict(D.attn_cache_specs(cfg, "global", batch, max_len))
    cross = (batch, cfg.enc_len, cfg.n_kv_heads, cfg.head_dim)
    axes = ("batch", None, "kv_heads", "head_dim")
    # layout="cross": written once at prefill from the encoder output,
    # read-only afterwards
    out["ck"] = ParamSpec(cross, axes, cfg.dtype, "zeros", layout="cross")
    out["cv"] = ParamSpec(cross, axes, cfg.dtype, "zeros", layout="cross")
    return out


def _cross_kv(cfg: ArchConfig, p, enc_out, serving: bool):
    """The encoder output's cross-attention K/V, (B, E, KVH, Dh) each."""
    b = enc_out.shape[0]

    def proj(eb):
        return eb @ p["xk"], eb @ p["xv"]

    ck, cv = L.row_blocked(proj, enc_out) if serving else proj(enc_out)
    return (ck.reshape(b, -1, cfg.n_kv_heads, cfg.head_dim),
            cv.reshape(b, -1, cfg.n_kv_heads, cfg.head_dim))


def _cross_attend(cfg: ArchConfig, p, x, ck, cv, serving: bool = True):
    """x + cross-attention of x's queries over the encoder K/V (no mask,
    no rotary positions)."""
    b, s, _ = x.shape
    e = ck.shape[1]
    dev = x.device

    def q_of(xb):
        return L.rms_norm(xb, p["ln_x"], cfg.norm_eps) @ p["xq"]

    q = (L.row_blocked(q_of, x) if serving else q_of(x)).reshape(
        b, s, cfg.n_heads, cfg.head_dim)
    q_pos = torch.zeros((b, s), dtype=torch.int32, device=dev)
    k_pos = torch.arange(e, dtype=torch.int32, device=dev).expand(b, e)
    if serving:
        out = L.ring_attention(q, ck, cv, q_positions=q_pos,
                               k_positions=k_pos, causal=False,
                               kv_valid=torch.ones((b, e), dtype=torch.bool,
                                                   device=dev))
        return x + L.row_blocked(lambda ob: ob @ p["xo"],
                                 out.reshape(b, s, -1))
    out = L.attention(q, ck, cv, q_positions=q_pos, k_positions=k_pos,
                      causal=False)
    return x + out.reshape(b, s, -1) @ p["xo"]


def dec_apply(cfg: ArchConfig, p, x, cache, positions, mode: str, pos=None,
              enc_out=None):
    """Decoder block of the serving paths: ring-cached causal
    self-attention, cross-attention, GELU MLP.  ``mode`` "prefill" fills
    the ring and writes the cross K/V of ``enc_out`` into the cache;
    "decode" writes one ring row per batch row at ``pos`` and reads the
    stored cross K/V.  The cache is written in place."""
    b, s, _ = x.shape
    q, k, v = D._qkv(cfg, p, x, positions)
    if mode == "prefill":
        C.ring_fill(cache, {"k": k, "v": v}, positions)
        if s <= cache["pos"].shape[1]:
            out = L.ring_attention(q, cache["k"], cache["v"],
                                   q_positions=positions,
                                   k_positions=cache["pos"],
                                   kv_valid=cache["pos"] >= 0)
        else:
            out = L.attention(q, k, v, q_positions=positions,
                              k_positions=positions)
        ck, cv = _cross_kv(cfg, p, enc_out, True)
        cache["ck"].copy_(ck)
        cache["cv"].copy_(cv)
    elif mode == "decode":
        C.ring_write(cache, {"k": k, "v": v}, pos)
        out = L.ring_attention(q, cache["k"], cache["v"],
                               q_positions=positions,
                               k_positions=cache["pos"],
                               kv_valid=cache["pos"] >= 0)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + L.row_blocked(lambda ob: ob @ p["wo"], out.reshape(b, s, -1))
    x = _cross_attend(cfg, p, x, cache["ck"], cache["cv"])
    return x + L.row_blocked(lambda xb: D.mlp_apply(
        cfg, p, L.rms_norm(xb, p["ln2"], cfg.norm_eps)), x), cache


def _dec_train(cfg: ArchConfig, p, x, positions, enc_out):
    """Decoder block of the training path (the reference's ``dec_apply``
    in mode "train")."""
    b, s, _ = x.shape
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    out = L.attention(q, k, v, q_positions=positions, k_positions=positions)
    x = x + out.reshape(b, s, -1) @ p["wo"]
    ck, cv = _cross_kv(cfg, p, enc_out, False)
    x = _cross_attend(cfg, p, x, ck, cv, serving=False)
    return x + D.mlp_apply(cfg, p, L.rms_norm(x, p["ln2"], cfg.norm_eps))


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def enc_layout(cfg: ArchConfig) -> S.PeriodLayout:
    return S.layout_from_kinds(("enc",) * cfg.enc_layers, 1)


def dec_layout(cfg: ArchConfig) -> S.PeriodLayout:
    return S.layout_from_kinds(("dec",) * cfg.n_layers, 1)


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "enc_stack": S.stack_specs(
            enc_layout(cfg), lambda kind: D.attn_mlp_specs(cfg, "enc")),
        "ln_enc": ParamSpec((cfg.d_model,), (None,), cfg.dtype, "zeros"),
        "embed": ParamSpec((cfg.vocab, cfg.d_model), (None, "embed"),
                           cfg.dtype),
        "unembed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                             cfg.dtype),
        "dec_stack": S.stack_specs(
            dec_layout(cfg), functools.partial(dec_specs, cfg)),
        "ln_f": ParamSpec((cfg.d_model,), (None,), cfg.dtype, "zeros"),
    }


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    return S.stack_cache_specs(
        dec_layout(cfg), lambda kind: dec_cache_specs(cfg, batch, max_len))


def encode(params, frames, cfg: ArchConfig):
    """The encoder over precomputed frames (B, E, d_model): bidirectional
    blocks, then the final norm.  Differentiable (training) and run under
    no_grad at prefill."""
    b, e, _ = frames.shape
    positions = torch.arange(e, dtype=torch.int32,
                             device=frames.device).expand(b, e)
    x, _ = S.apply_stack(
        params["enc_stack"], frames.to(cfg.dtype), enc_layout(cfg),
        lambda kind, p, xx, c: (D.train_block(cfg, "enc", p, xx, positions),
                                c),
        remat=cfg.remat == "block")
    return L.rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _run_decoder(cfg, params, x, positions, cache, mode, pos=None,
                 enc_out=None):
    x, cache = S.apply_stack(
        params["dec_stack"], x, dec_layout(cfg),
        lambda kind, p, xx, c: dec_apply(cfg, p, xx, c, positions, mode, pos,
                                         enc_out), cache=cache)
    return L.row_blocked(lambda xb: L.rms_norm(xb, params["ln_f"],
                                               cfg.norm_eps), x), cache


def forward_train(params, batch, cfg: ArchConfig, dist=None):
    """Token-mean next-token loss of ``batch["tokens"]`` (B, S) given
    ``batch["frames"]`` (B, E, d_model) (masked by ``batch["loss_mask"]``
    if given); returns (loss, {"loss": loss})."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = L.embed(tokens, params["embed"])
    x, _ = S.apply_stack(
        params["dec_stack"], x, dec_layout(cfg),
        lambda kind, p, xx, c: (_dec_train(cfg, p, xx, positions, enc_out),
                                c),
        remat=cfg.remat == "block")
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    loss = L.lm_head_loss(x[:, :-1], params["unembed"], tokens[:, 1:],
                          batch.get("loss_mask"))
    return loss, {"loss": loss}


@torch.no_grad()
def prefill(params, batch, cfg: ArchConfig, max_len: int, dist=None):
    """Encode ``batch["frames"]``, then prefill the decoder on
    ``batch["tokens"]``: returns (last-token logits (B, V) float32, the
    cache with its rings and cross K/V)."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    cache = C.init_cache(cache_specs(cfg, b, max_len), dev)
    x = L.embed(tokens, params["embed"])
    x, cache = _run_decoder(cfg, params, x, positions, cache, "prefill",
                            enc_out=enc_out)
    logits = L.unembed(x[:, -1:], params["unembed"])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, cache, batch, pos, cfg: ArchConfig, dist=None,
                fault_ctx=None):
    """batch["tokens"]: (B, 1); ``pos``: a scalar position or a (B,)
    per-row position tensor (rows at a negative position skip their ring
    write).  Returns ((B, V) logits, the cache written in place).
    ``fault_ctx`` must be None: this family's faults ride the write
    path."""
    if fault_ctx is not None:
        raise ValueError(
            f"family {cfg.family!r} has no read path (no "
            "SUPPORTS_READ_PATH): its faults ride the write path")
    tokens = batch["tokens"]
    b = tokens.shape[0]
    positions = C.decode_positions(pos, b, 1, tokens.device)
    x = L.embed(tokens, params["embed"])
    x, cache = _run_decoder(cfg, params, x, positions, cache, "decode",
                            pos=pos)
    logits = L.unembed(x, params["unembed"])
    return logits[:, 0], cache
