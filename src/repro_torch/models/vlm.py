"""InternVL2 family: ViT frontend (stub) + InternLM2-style dense decoder
(port of :mod:`repro.models.vlm`).

``batch["patches"]`` holds precomputed patch embeddings (B, enc_len,
frontend_dim); this module owns the projector (ViT width -> d_model) and
the language model, a :mod:`dense` decoder.  Image tokens occupy
positions [0, enc_len), text follows, so decode positions start at
``prompt_len + enc_len``; the training loss covers text positions only.

Row invariance: the projector runs through :func:`layers.row_blocked`
and decode attention through :func:`layers.ring_attention`, so a
state-arena slot row equals the request decoded alone.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import cache as C
from repro_torch.models import dense as D
from repro_torch.models import layers as L
from repro_torch.models import stack as S
from repro_torch.models.base import ArchConfig, ParamSpec


def param_specs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "lm": D.param_specs(cfg),
        "proj_w": ParamSpec((cfg.frontend_dim, cfg.d_model),
                            ("frontend", "embed"), cfg.dtype),
        "proj_b": ParamSpec((cfg.d_model,), (None,), cfg.dtype, "zeros"),
    }


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> Dict[str, Any]:
    return D.cache_specs(cfg, batch, max_len)


def _embed_multimodal(params, batch, cfg: ArchConfig, serving: bool = True):
    """Projected image tokens, then the text tokens' embeddings: (B,
    enc_len + S_text, d_model)."""
    patches = batch["patches"].to(cfg.dtype)     # (B, enc_len, vit_dim)

    def proj(pb):
        return pb @ params["proj_w"] + params["proj_b"]

    img = L.row_blocked(proj, patches) if serving else proj(patches)
    txt = L.embed(batch["tokens"], params["lm"]["embed"])
    return torch.cat([img, txt], dim=1)


def _run_stack(cfg, params, x, positions, cache, mode, pos=None):
    return D._run_stack(cfg, params["lm"], x, positions, cache, mode, pos=pos,
                        decode_attn=L.ring_attention)


def forward_train(params, batch, cfg: ArchConfig, dist=None):
    """Token-mean next-token loss over the text tokens (the hidden state
    at position enc_len - 1 + t predicts text token t), masked by
    ``batch["loss_mask"]`` if given; returns (loss, {"loss": loss})."""
    x = _embed_multimodal(params, batch, cfg, serving=False)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x, _ = S.apply_stack(
        params["lm"]["stack"], x, D.layout(cfg),
        lambda kind, p, xx, c: (D.train_block(cfg, kind, p, xx, positions),
                                c),
        remat=cfg.remat == "block")
    x = L.rms_norm(x, params["lm"]["ln_f"], cfg.norm_eps)
    n_img = cfg.enc_len
    loss = L.lm_head_loss(x[:, n_img - 1:-1], params["lm"]["unembed"],
                          batch["tokens"], batch.get("loss_mask"))
    return loss, {"loss": loss}


@torch.no_grad()
def prefill(params, batch, cfg: ArchConfig, max_len: int, dist=None):
    """Prefill over the image and text tokens: returns (last-token logits
    (B, V) float32, the filled cache)."""
    x = _embed_multimodal(params, batch, cfg)
    b, s, _ = x.shape
    dev = x.device
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    cache = C.init_cache(cache_specs(cfg, b, max_len), dev)
    x, cache = _run_stack(cfg, params, x, positions, cache, "prefill")
    logits = L.unembed(x[:, -1:], params["lm"]["unembed"])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, cache, batch, pos, cfg: ArchConfig, dist=None,
                fault_ctx=None):
    """batch["tokens"]: (B, 1); ``pos``: a scalar position or a (B,)
    per-row position tensor (``prompt_len + enc_len`` at the first step;
    rows at a negative position skip their ring write).  Returns ((B, V)
    logits, the cache written in place).  ``fault_ctx`` must be None:
    this family's faults ride the write path."""
    if fault_ctx is not None:
        raise ValueError(
            f"family {cfg.family!r} has no read path (no "
            "SUPPORTS_READ_PATH): its faults ride the write path")
    tokens = batch["tokens"]
    b = tokens.shape[0]
    positions = C.decode_positions(pos, b, 1, tokens.device)
    x = L.embed(tokens, params["lm"]["embed"])
    x, cache = _run_stack(cfg, params, x, positions, cache, "decode",
                          pos=pos)
    logits = L.unembed(x, params["lm"]["unembed"])
    return logits[:, 0], cache
