"""RecurrentGemma / Griffin family: RG-LRU recurrent blocks + local
attention (port of :mod:`repro.models.rglru`).

Pattern (rec, rec, local) repeating, period-stacked with heterogeneous
slot caches: recurrent slots carry a constant-size state (B, lru) plus
the conv tail, attention slots a window-sized ring.  The RG-LRU
recurrence h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), its gate
math included, runs through
:func:`repro_torch.kernels.rglru.ops.rglru_gated_scan` -- one K8 launch on
the card, in prefill and at every decode step -- and the local layers'
prefill attention through :func:`repro_torch.kernels.flash_attention.
ops.flash_attention` (K7).  Caches are written in place.

Every row-wise stage (norms, projections, the float32 gate products, the
MLP) runs through :func:`layers.row_blocked` and decode attention through
:func:`layers.ring_attention`, so a row's bits do not depend on how many
rows are decoded with it: slot-batched decode in the state-arena
scheduler equals a request decoded alone.

Training (:func:`forward_train`) follows the reference's train mode,
which runs no Pallas kernel: whole-tensor products, local attention with
its flash-style backward (:func:`layers.attention`), and the recurrence
as a log-depth scan in plain PyTorch (:func:`_linear_scan`), which
autograd differentiates; K7 and K8 stay on the serving paths.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rglru.ops import rglru_gated_scan
# RGLRU_C: the recurrence's sharpness constant, applied in the gate math
from repro_torch.kernels.rglru.ref import RGLRU_C, rglru_gates_ref  # noqa: F401
from repro_torch.models import cache as C
from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.models import stack as S
from repro_torch.models.base import ArchConfig, ParamSpec


def rec_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, dt, r = cfg.d_model, cfg.dtype, cfg.lru_width
    return {
        "ln1": ParamSpec((d,), (None,), dt, "zeros"),
        "w_a": ParamSpec((d, r), ("embed", "mlp"), dt),     # gelu branch
        "w_b": ParamSpec((d, r), ("embed", "mlp"), dt),     # recurrent branch
        "conv_w": ParamSpec((cfg.conv_width, r), (None, "mlp"), dt),
        "conv_b": ParamSpec((r,), ("mlp",), dt, "zeros"),
        "w_rg": ParamSpec((r, r), ("mlp", None), dt),       # recurrence gate
        "b_rg": ParamSpec((r,), (None,), dt, "zeros"),
        "w_ig": ParamSpec((r, r), ("mlp", None), dt),       # input gate
        "b_ig": ParamSpec((r,), (None,), dt, "zeros"),
        # Lambda init => a ~ 0.95 at r_g ~ 0.5 (Griffin's stable-decay init)
        "lam": ParamSpec((r,), (None,), torch.float32, "const", scale=-4.38),
        "w_out": ParamSpec((r, d), ("mlp", "embed"), dt),
        "ln2": ParamSpec((d,), (None,), dt, "zeros"),
        "wg": ParamSpec((d, cfg.d_ff), ("embed", "mlp"), dt),
        "wu": ParamSpec((d, cfg.d_ff), ("embed", "mlp"), dt),
        "wd": ParamSpec((cfg.d_ff, d), ("mlp", "embed"), dt),
    }


def rec_cache_specs(cfg: ArchConfig, batch: int) -> Dict[str, ParamSpec]:
    r = cfg.lru_width
    return {
        "h": ParamSpec((batch, r), ("batch", "mlp"), torch.float32, "zeros"),
        "conv": ParamSpec((batch, cfg.conv_width - 1, r),
                          ("batch", None, "mlp"), cfg.dtype, "zeros"),
    }


def _rglru(y, p, h):
    """RG-LRU over a sequence.  y: (B, S, R); h: (B, R) float32, the
    carried state, overwritten with the last one.  Returns h (B, S, R),
    float32."""
    w_rg, b_rg = p["w_rg"].float(), p["b_rg"].float()
    w_ig, b_ig = p["w_ig"].float(), p["b_ig"].float()

    def gates(yb):
        yf = yb.float()
        return (torch.sigmoid(yf @ w_rg + b_rg),
                torch.sigmoid(yf @ w_ig + b_ig))

    r_g, i_g = L.row_blocked(gates, y)
    hseq, _ = rglru_gated_scan(r_g, i_g, y, p["lam"], h, h_last=h)
    return hseq


def rec_apply(cfg: ArchConfig, p, x, cache):
    """One recurrent block; writes the new state and conv tail into
    ``cache`` in place."""
    def branches(xb):
        h = L.rms_norm(xb, p["ln1"], cfg.norm_eps)
        return L.gelu(h @ p["w_a"]), h @ p["w_b"]

    branch_a, yb = L.row_blocked(branches, x)
    yb, new_tail = L.causal_conv(yb, p["conv_w"], p["conv_b"], cache["conv"])
    hseq = _rglru(yb, p, cache["h"])
    merged = branch_a * hseq.to(x.dtype)
    x = x + L.row_blocked(lambda mb: mb @ p["w_out"], merged)
    x = x + L.row_blocked(lambda xb: L.gated_mlp(
        L.rms_norm(xb, p["ln2"], cfg.norm_eps), p["wg"], p["wu"], p["wd"],
        act="gelu"), x)
    cache["conv"].copy_(new_tail)
    return x, cache


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def slot_specs(cfg: ArchConfig, kind: str):
    if kind == "rec":
        return rec_specs(cfg)
    return D.attn_mlp_specs(cfg, kind)   # "local"


def slot_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int):
    if kind == "rec":
        return rec_cache_specs(cfg, batch)
    return D.attn_cache_specs(cfg, kind, batch, max_len)


def layout(cfg: ArchConfig) -> S.PeriodLayout:
    return S.layout_from_kinds(cfg.layer_kinds(), len(cfg.pattern))


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), (None, "embed"),
                           cfg.dtype),
        "unembed": ParamSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                             cfg.dtype),
        "stack": S.stack_specs(layout(cfg),
                               functools.partial(slot_specs, cfg)),
        "ln_f": ParamSpec((cfg.d_model,), (None,), cfg.dtype, "zeros"),
    }


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    return S.stack_cache_specs(
        layout(cfg), lambda kind: slot_cache(cfg, kind, batch, max_len))


def _embed(cfg: ArchConfig, params, tokens):
    """Token embedding times sqrt(d_model), rounded to the model dtype
    first, as the reference scales it.  The scale is made on the tokens'
    device (a fill, no host copy, so a captured step may hold it)."""
    scale = torch.full((), float(cfg.d_model), dtype=torch.float32,
                       device=tokens.device).sqrt()
    return L.embed(tokens, params["embed"]) * scale.to(cfg.dtype)


def _run_stack(cfg, params, x, positions, cache, mode, pos=None):
    def apply_slot(kind, p, xx, c):
        if kind == "rec":
            return rec_apply(cfg, p, xx, c)
        return D.attn_mlp_apply(cfg, kind, p, xx, c, positions, mode, pos,
                                prefill_attn=flash_attention,
                                decode_attn=L.ring_attention)

    x, cache = S.apply_stack(params["stack"], x, layout(cfg), apply_slot,
                             cache=cache)
    return L.row_blocked(lambda xb: L.rms_norm(xb, params["ln_f"],
                                               cfg.norm_eps), x), cache


def _linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h_{-1} = 0, as a
    Hillis-Steele scan: log2(S) rounds of the reference's combine
    ``(a1 * a2, b1 * a2 + b2)`` with the element ``d`` steps back."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _rec_train(cfg: ArchConfig, p, x):
    """One recurrent block of the training path (the reference's
    ``rec_apply`` with no cache: zero conv tail, h0 = 0)."""
    hpre = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    branch_a = L.gelu(hpre @ p["w_a"])
    yb = hpre @ p["w_b"]
    tail = yb.new_zeros((yb.shape[0], cfg.conv_width - 1, yb.shape[2]))
    yb, _ = L.causal_conv(yb, p["conv_w"], p["conv_b"], tail)
    yf = yb.float()
    r_g = torch.sigmoid(yf @ p["w_rg"].float() + p["b_rg"].float())
    i_g = torch.sigmoid(yf @ p["w_ig"].float() + p["b_ig"].float())
    hseq = _linear_scan(*rglru_gates_ref(r_g, i_g, yf, p["lam"]))
    x = x + (branch_a * hseq.to(x.dtype)) @ p["w_out"]
    return x + L.gated_mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["wg"],
                           p["wu"], p["wd"], act="gelu")


def forward_train(params, batch, cfg: ArchConfig, dist=None):
    """Token-mean next-token loss of ``batch["tokens"]`` (B, S) (masked by
    ``batch["loss_mask"]`` if given); returns (loss, {"loss": loss}),
    differentiable in ``params``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)

    def apply_slot(kind, p, xx, c):
        if kind == "rec":
            return _rec_train(cfg, p, xx), c
        return D.train_block(cfg, kind, p, xx, positions), c

    x = _embed(cfg, params, tokens)
    x, _ = S.apply_stack(params["stack"], x, layout(cfg), apply_slot,
                         remat=cfg.remat == "block")
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    loss = L.lm_head_loss(x[:, :-1], params["unembed"], tokens[:, 1:],
                          batch.get("loss_mask"))
    return loss, {"loss": loss}


@torch.no_grad()
def prefill(params, batch, cfg: ArchConfig, max_len: int, dist=None):
    """Exact (unpadded) prefill: returns (last-token logits (B, V) f32,
    the filled cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    cache = C.init_cache(cache_specs(cfg, b, max_len), dev)
    x = _embed(cfg, params, tokens)
    x, cache = _run_stack(cfg, params, x, positions, cache, "prefill")
    logits = L.unembed(x[:, -1:], params["unembed"])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, cache, batch, pos, cfg: ArchConfig, dist=None,
                fault_ctx=None):
    """batch["tokens"]: (B, 1); ``pos``: a scalar absolute position or a
    (B,) per-row position tensor (rows at a negative position skip their
    ring write; their recurrent state still advances, as in the
    reference).  Returns ((B, V) logits, the cache written in place).
    ``fault_ctx`` must be None: this family has no read path, so faults
    ride the write path."""
    if fault_ctx is not None:
        raise ValueError(
            f"family {cfg.family!r} has no read path (no "
            "SUPPORTS_READ_PATH): its faults ride the write path")
    tokens = batch["tokens"]
    b = tokens.shape[0]
    positions = C.decode_positions(pos, b, 1, tokens.device)
    x = _embed(cfg, params, tokens)
    x, cache = _run_stack(cfg, params, x, positions, cache, "decode",
                          pos=pos)
    logits = L.unembed(x, params["unembed"])
    return logits[:, 0], cache
