"""DeepSeek-V2 family: MLA attention + fine-grained MoE with shared
experts (port of :mod:`repro.models.moe`).

MLA (multi-head latent attention) caches only the compressed latent
(``kv_lora_rank``) plus the decoupled rope key -- 576 values per token for
V2 -- and decodes in the *absorbed* form (queries projected into latent
space), so decode reads the small cache instead of per-head K/V.

The routed FFN is the reference's sort-based capacity dispatch with its
expert parallelism computed on one device (:func:`moe_ffn`): router
softmax, top-k and renormalisation over every token (global, as in the
reference); then, for each data shard of ``dist``'s mesh, the capacity
from that shard's tokens (at decode ``cap = max(cap, tokens)`` so nothing
drops), and for each model shard ``j`` the reference's ``shard_map``
body: a stable sort of the shard's (token, choice) pairs by local expert
(pairs of other shards' experts sort last, into the overflow slot), a
within-expert rank, capacity drops, the local experts' MLPs over the
(local experts, capacity, d) buffer and the combine; the model shards'
partial outputs are summed in shard order (the reference's ``psum``,
:func:`repro_torch.models.dist.psum_model`).  ``dist=None`` is the one-
shard case.

Row invariance (see :mod:`repro_torch.models.layers`): the state-arena
scheduler decodes every slot in one step and must give each request the
bits it gets alone, so

  * every row-wise stage (norms, projections, router, shared experts,
    the output head) runs through :func:`layers.row_blocked`, and decode
    attention over the latent ring through :func:`layers.ring_attention`;
  * top-k is a stable descending sort (``jax.lax.top_k`` breaks ties
    toward the lower index; ``torch.topk`` promises no order);
  * the expert products run on fixed blocks of :data:`layers.ROW_BLOCK`
    capacity rows per expert (:func:`_expert_mlp`), so a token's row has
    the same bits whatever the capacity (which grows with the batch at
    decode);
  * the combine sums each token's ``top_k`` contributions in ascending
    expert order, the order of the reference's ``.at[tok].add`` over the
    expert-sorted pairs, elementwise -- not ``index_add_``, whose CUDA
    atomics are not bit-stable.

The expert gate and up products of a bf16 model are rounded to bf16
before the float32 SiLU (``torch.bmm`` has no ``preferred_element_type``;
the reference keeps them in float32); float32 models agree with the
reference within float32 rounding.  Everything else is plain PyTorch, as
the reference computes it with XLA ``einsum``s outside any Pallas kernel.
Nothing here reads a device value on the host, so a decode step captures
as one CUDA graph.

Training (:func:`forward_train`, mode "train") runs the row-wise stages
as whole-tensor products, as the reference's ``einsum``s are, and MLA
over the materialized per-head K/V through :func:`layers.attention` (its
flash-style backward).  The routed FFN is the serving dispatch at the
training capacity ``ceil(capacity_factor * tokens * top_k / experts)``
over a data shard's tokens:
the same stable sort, so the same (token, choice) pairs drop as in the
reference; its fixed expert row blocks and the gather-and-sum combine
keep the backward free of atomics.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import pytree
from repro_torch.models import cache as C
from repro_torch.models import dist as D
from repro_torch.models import layers as L
from repro_torch.models import stack as S
from repro_torch.models.base import ArchConfig, ParamSpec

ROUTER_AUX_COEF = 1e-3


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------


def mla_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, dt = cfg.d_model, cfg.dtype
    h, dn, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    kvl = cfg.kv_lora_rank
    out = {
        "ln1": ParamSpec((d,), (None,), dt, "zeros"),
        "w_dkv": ParamSpec((d, kvl), ("embed", None), dt),
        "ln_kv": ParamSpec((kvl,), (None,), dt, "zeros"),
        "w_kpe": ParamSpec((d, dr), ("embed", None), dt),
        "w_uk": ParamSpec((kvl, h, dn), (None, "heads", None), dt),
        "w_uv": ParamSpec((kvl, h, dn), (None, "heads", None), dt),
        "w_o": ParamSpec((h, dn, d), ("heads", None, "embed"), dt),
    }
    if cfg.q_lora_rank:
        out["w_dq"] = ParamSpec((d, cfg.q_lora_rank), ("embed", None), dt)
        out["ln_q"] = ParamSpec((cfg.q_lora_rank,), (None,), dt, "zeros")
        out["w_uq"] = ParamSpec((cfg.q_lora_rank, h, dn + dr),
                                (None, "heads", None), dt)
    else:
        out["w_q"] = ParamSpec((d, h, dn + dr), ("embed", "heads", None), dt)
    return out


def mla_cache_specs(cfg: ArchConfig, batch: int,
                    max_len: int) -> Dict[str, ParamSpec]:
    return {
        "ckv": ParamSpec((batch, max_len, cfg.kv_lora_rank),
                         ("batch", "cache_seq", "kv_lora"), cfg.dtype,
                         "zeros"),
        "kpe": ParamSpec((batch, max_len, cfg.rope_head_dim),
                         ("batch", "cache_seq", None), cfg.dtype, "zeros"),
        "pos": ParamSpec((batch, max_len), ("batch", "cache_seq"),
                         torch.int32, "zeros"),
    }


def _whole(fn, x):
    """``fn`` over all rows of ``x`` at once: the training path's stand-in
    for :func:`layers.row_blocked`."""
    return fn(x)


def _rows(mode: str):
    return _whole if mode == "train" else L.row_blocked


def _mla_proj(cfg: ArchConfig, p, x, positions, rows=L.row_blocked):
    """RMSNorm and the query / latent / rope-key projections (through
    ``rows``: row-blocked when serving), then RoPE: (q_nope, q_pe, ckv,
    kpe)."""
    b, s, _ = x.shape
    h_, dn, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim

    def proj(xb):
        h = L.rms_norm(xb, p["ln1"], cfg.norm_eps)
        if cfg.q_lora_rank:
            cq = L.rms_norm(h @ p["w_dq"], p["ln_q"], cfg.norm_eps)
            q = cq @ p["w_uq"].reshape(cfg.q_lora_rank, -1)
        else:
            q = h @ p["w_q"].reshape(cfg.d_model, -1)
        ckv = L.rms_norm(h @ p["w_dkv"], p["ln_kv"], cfg.norm_eps)
        return q, ckv, h @ p["w_kpe"]

    q, ckv, kpe = rows(proj, x)
    q = q.reshape(b, s, h_, dn + dr)
    q_pe = L.rope(q[..., dn:], positions, cfg.rope_theta)
    kpe = L.rope(kpe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q[..., :dn], q_pe, ckv, kpe


def _heads_blocked(fn, x):
    """``fn`` over (ROW_BLOCK, H, e) blocks of the (B, S, H, e) tensor
    ``x`` (see :func:`layers.row_blocked`)."""
    b, s, h, e = x.shape
    out = L.row_blocked(lambda xb: fn(xb.reshape(-1, h, e)).reshape(
        xb.shape[0], -1), x.reshape(b, s, h * e))
    return out.reshape(b, s, h, -1)


def mla_attn(cfg: ArchConfig, p, x, cache, positions, mode: str, pos=None):
    """One MLA block (pre-norm residual).  mode: train | prefill |
    decode.  Train and prefill attend over the materialized per-head K/V
    of the sequence (prefill also fills the latent ring; train has no
    cache); decode writes the ring in place and attends in the absorbed
    form over the whole latent ring."""
    b, s, _ = x.shape
    h_, dn, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    scale = (dn + dr) ** -0.5
    rows = _rows(mode)
    q_nope, q_pe, ckv, kpe = _mla_proj(cfg, p, x, positions, rows)
    if mode in ("train", "prefill"):
        kv = rows(lambda cb: (
            torch.einsum("...k,khd->...hd", cb, p["w_uk"]).flatten(-2),
            torch.einsum("...k,khd->...hd", cb, p["w_uv"]).flatten(-2)),
            ckv)
        k_nope = kv[0].reshape(b, s, h_, dn)
        vv = kv[1].reshape(b, s, h_, dn)
        k_full = torch.cat(
            [k_nope, kpe[:, :, None, :].expand(b, s, h_, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        out = L.attention(q_full, k_full, vv, q_positions=positions,
                          k_positions=positions, causal=True,
                          softmax_scale=scale)
        if mode == "prefill":
            C.ring_fill(cache, {"ckv": ckv, "kpe": kpe}, positions)
    elif mode == "decode":
        C.ring_write(cache, {"ckv": ckv, "kpe": kpe}, pos)
        q_c = _heads_blocked(
            lambda qb: torch.einsum("rhd,khd->rhk", qb, p["w_uk"]), q_nope)
        q_cat = torch.cat([q_c, q_pe], dim=-1)          # (B, S, H, kvl+dr)
        k_cat = torch.cat([cache["ckv"], cache["kpe"]],
                          dim=-1)[:, :, None, :]         # (B, L, 1, kvl+dr)
        v_lat = cache["ckv"][:, :, None, :]             # (B, L, 1, kvl)
        ctx = L.ring_attention(q_cat, k_cat, v_lat, q_positions=positions,
                               k_positions=cache["pos"],
                               kv_valid=cache["pos"] >= 0, causal=True,
                               softmax_scale=scale)      # (B, S, H, kvl)
        out = _heads_blocked(
            lambda cb: torch.einsum("rhk,khd->rhd", cb, p["w_uv"]), ctx)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    w_o = p["w_o"].reshape(h_ * dn, cfg.d_model)
    return x + rows(lambda ob: ob @ w_o, out.reshape(b, s, h_ * dn)), cache


# ---------------------------------------------------------------------------
# Routed MoE FFN
# ---------------------------------------------------------------------------


def moe_ffn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, dt, e, f = cfg.d_model, cfg.dtype, cfg.n_experts, cfg.d_ff
    shared_f = cfg.n_shared_experts * cfg.d_ff
    return {
        "ln2": ParamSpec((d,), (None,), dt, "zeros"),
        "w_router": ParamSpec((d, e), ("embed", None), torch.float32),
        "we_g": ParamSpec((e, d, f), ("experts", "embed", None), dt),
        "we_u": ParamSpec((e, d, f), ("experts", "embed", None), dt),
        "we_d": ParamSpec((e, f, d), ("experts", None, "embed"), dt),
        "ws_g": ParamSpec((d, shared_f), ("embed", "mlp"), dt),
        "ws_u": ParamSpec((d, shared_f), ("embed", "mlp"), dt),
        "ws_d": ParamSpec((shared_f, d), ("mlp", "embed"), dt),
    }


def _top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    ties toward the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ArchConfig, tokens: int, decode: bool) -> int:
    """Per-expert capacity of a dispatch over ``tokens`` tokens (train and
    prefill: ``ceil(capacity_factor * tokens * top_k / experts)``).
    Decode (one token per row) never drops: serving batches many
    requests into one step, and a drop the request's solo replay would
    not take breaks the replay; each token's experts are distinct, so
    ``tokens`` bounds an expert's load."""
    cap = max(1, int(math.ceil(cfg.capacity_factor * tokens * cfg.top_k
                               / cfg.n_experts)))
    return max(cap, tokens) if decode else cap


def _expert_mlp(eb, wg, wu, wd):
    """The experts' gated MLPs over the (E, cap, d) dispatch buffer, on
    blocks of exactly ROW_BLOCK capacity rows per expert (the last one
    zero-padded): a row's bits do not depend on the capacity."""
    e, cap, d = eb.shape
    r = L.ROW_BLOCK
    pad = (-cap) % r
    if pad:
        eb = torch.cat([eb, eb.new_zeros((e, pad, d))], dim=1)
    outs = []
    for i in range(0, cap + pad, r):
        xb = eb[:, i:i + r]
        gate = F.silu(torch.bmm(xb, wg).float())
        up = torch.bmm(xb, wu).float()
        outs.append(torch.bmm((gate * up).to(xb.dtype), wd))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out[:, :cap]


def dispatch(top_e, n_experts: int, cap: int, first: int = 0):
    """The capacity dispatch of the (token, choice) pairs ``top_e`` (...,
    k) to the ``n_experts`` experts ``[first, first + n_experts)`` (one
    model shard's local experts): ``order``, the pairs (flat index
    ``token * k + choice``) stably sorted by local expert, the pairs of
    other experts last, and ``slot``, each sorted pair's row of the
    (n_experts x cap + 1) buffer -- ``n_experts * cap``, the sink, for a
    pair of another shard's expert or past its expert's capacity
    (dropped)."""
    fe = top_e.reshape(-1)
    loc = torch.where((fe >= first) & (fe < first + n_experts), fe - first,
                      torch.full_like(fe, n_experts))
    order = torch.argsort(loc, stable=True)
    se = loc[order]
    rank = (torch.arange(fe.shape[0], device=fe.device)
            - torch.searchsorted(se, se, right=False))
    slot = torch.where((se < n_experts) & (rank < cap), se * cap + rank,
                       torch.full_like(se, n_experts * cap))
    return order, slot


def _local_experts(p, x2, top_e, fw, first: int, e_loc: int, cap: int,
                   p_first: Optional[int] = None):
    """One model shard's part of the routed FFN over one data shard's
    tokens ``x2`` (t, d): the dispatch to experts ``[first, first +
    e_loc)``, their MLPs and the combine, each token's contributions
    summed in ascending expert order (another shard's expert adds a
    zero).  The experts' weights are rows ``[p_first, p_first + e_loc)``
    of ``p``'s expert leaves (``first`` by default; 0 on a rank that
    holds only its own experts)."""
    t, d = x2.shape
    k = top_e.shape[-1]
    order, slot = dispatch(top_e, e_loc, cap, first)
    tok = order // k
    buf = x2.new_zeros((e_loc * cap + 1, d))
    buf[slot] = x2[tok]
    p0 = first if p_first is None else p_first
    sl = slice(p0, p0 + e_loc)
    ob = _expert_mlp(buf[:e_loc * cap].reshape(e_loc, cap, d),
                     p["we_g"][sl], p["we_u"][sl], p["we_d"][sl])
    of = torch.cat([ob.reshape(e_loc * cap, d), x2.new_zeros((1, d))])
    contrib = torch.empty((t * k, d), dtype=x2.dtype, device=x2.device)
    contrib[order] = of[slot] * fw[order][:, None]
    # each token's contributions in ascending expert order, summed
    # elementwise from zero (the reference's scatter-add order)
    asc = torch.argsort(top_e, dim=-1)
    contrib = torch.gather(contrib.reshape(t, k, d), 1,
                           asc[..., None].expand(t, k, d))
    y = x2.new_zeros((t, d))
    for j in range(k):
        y = y + contrib[:, j]
    return y


def moe_ffn(cfg: ArchConfig, p, x, rows=L.row_blocked, dist=None):
    """Routed experts; returns (y, aux_loss).  x: (B, S, d); the router
    runs through ``rows`` (row-blocked when serving).  ``dist`` (a
    :class:`repro_torch.models.dist.DistContext`) splits the batch into
    its data shards and the experts into its model shards, as the
    reference's ``shard_map`` does; None is one shard of each.  On a rank
    mesh ``x`` is this rank's data shard and ``p``'s expert leaves hold
    only its model shard's experts (:func:`_moe_ffn_rank`)."""
    if dist is not None and dist.on_ranks:
        return _moe_ffn_rank(cfg, p, x, rows, dist)
    e, k = cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    n_data = 1 if dist is None else dist.data_size
    n_model = 1 if dist is None else dist.model_size
    e_loc = e // n_model
    if e_loc * n_model != e or b % n_data:
        raise ValueError(f"{e} experts x batch {b} do not split over "
                         f"{n_model} model x {n_data} data shards")
    w_router = p["w_router"].float()
    probs = rows(lambda xb: torch.softmax(xb.float() @ w_router, dim=-1), x)
    top_w, top_e = _top_k(probs, k)
    top_w = rows(lambda wb: wb / wb.sum(dim=-1, keepdim=True), top_w)
    # Switch-style load-balance loss: the routed fraction carries no
    # gradient, the mean probability does.  The one-hot is a comparison,
    # since F.one_hot reads the indices' range on the host, which a
    # captured step must not
    hot = top_e[..., None] == torch.arange(e, device=x.device)
    frac = hot.float().mean(dim=(0, 1, 2))
    aux = e * torch.sum(frac * probs.mean(dim=(0, 1)))

    bl = b // n_data
    t = bl * s
    cap = capacity(cfg, t, decode=s == 1)
    axis = "model" if dist is None else dist.model_axis
    ys = []
    for i in range(n_data):
        rs = slice(i * bl, (i + 1) * bl)
        x2 = x[rs].reshape(t, d)
        te = top_e[rs].reshape(t, k)
        fw = top_w[rs].reshape(t * k).to(x2.dtype)
        y = D.psum_model([_local_experts(p, x2, te, fw, j * e_loc, e_loc,
                                         cap) for j in range(n_model)],
                         axis)
        ys.append(y.reshape(bl, s, d))
    return (ys[0] if n_data == 1 else torch.cat(ys)), aux


def _moe_ffn_rank(cfg: ArchConfig, p, x, rows, dist):
    """:func:`moe_ffn` on one rank of a rank mesh: its data shard's rows
    ``x`` (bl, S, d) routed to its model shard's experts (rows ``j *
    e_loc ..`` of the routing, rows ``0 ..`` of its own expert leaves).
    The load-balance statistics are means over the global batch (over
    the data ranks); capacity is per data shard, as on the logical mesh;
    the partial outputs are summed over the model ranks in rank order."""
    e, k = cfg.n_experts, cfg.top_k
    b, s, d = x.shape
    n_model = dist.model_size
    e_loc = e // n_model
    if e_loc * n_model != e:
        raise ValueError(f"{e} experts do not split over {n_model} model "
                         "ranks")
    if p["we_g"].shape[0] != e_loc:
        raise ValueError(
            f"rank holds {p['we_g'].shape[0]} experts, its model shard has "
            f"{e_loc}: a rank's state holds only its own experts "
            "(launch.sharding.split_state)")
    w_router = p["w_router"].float()
    probs = rows(lambda xb: torch.softmax(xb.float() @ w_router, dim=-1), x)
    top_w, top_e = _top_k(probs, k)
    top_w = rows(lambda wb: wb / wb.sum(dim=-1, keepdim=True), top_w)
    hot = top_e[..., None] == torch.arange(e, device=x.device)
    frac = D.data_mean(hot.float().mean(dim=(0, 1, 2)), dist)
    aux = e * torch.sum(frac * D.data_mean(probs.mean(dim=(0, 1)), dist))
    t = b * s
    cap = capacity(cfg, t, decode=s == 1)
    x2 = D.model_grad_sum(x.reshape(t, d), dist)
    fw = D.model_grad_sum(top_w.reshape(t * k).to(x2.dtype), dist)
    part = _local_experts(p, x2, top_e.reshape(t, k), fw,
                          dist.model_index * e_loc, e_loc, cap, p_first=0)
    y = D.psum_model([part], dist.model_axis, dist)
    return y.reshape(b, s, d), aux


def dense_ffn_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, dt = cfg.d_model, cfg.dtype
    f = cfg.d_ff_dense or 4 * d
    return {
        "ln2": ParamSpec((d,), (None,), dt, "zeros"),
        "wg": ParamSpec((d, f), ("embed", "mlp"), dt),
        "wu": ParamSpec((d, f), ("embed", "mlp"), dt),
        "wd": ParamSpec((f, d), ("mlp", "embed"), dt),
    }


# ---------------------------------------------------------------------------
# whole-model functions
# ---------------------------------------------------------------------------


def slot_specs(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    out = dict(mla_specs(cfg))
    if kind == "moe":
        out.update(moe_ffn_specs(cfg))
    else:  # densemlp: deepseek's first layer
        out.update(dense_ffn_specs(cfg))
    return out


def layout(cfg: ArchConfig) -> S.PeriodLayout:
    kinds = ("densemlp",) + ("moe",) * (cfg.n_layers - 1)
    return S.layout_from_kinds(kinds, 1, prefix_len=1)


def slot_apply(cfg: ArchConfig, kind: str, p, x, cache, positions,
               mode: str, pos=None, dist=None):
    """One layer: MLA, then the routed + shared experts (or layer 0's
    dense MLP; ``dist`` shards the routed experts).  Returns (x, cache,
    aux)."""
    rows = _rows(mode)
    x, cache = mla_attn(cfg, p, x, cache, positions, mode, pos)
    h2 = rows(lambda xb: L.rms_norm(xb, p["ln2"], cfg.norm_eps), x)
    if kind == "moe":
        routed, aux = moe_ffn(cfg, p, h2, rows, dist)
        shared = rows(lambda hb: L.gated_mlp(
            hb, p["ws_g"], p["ws_u"], p["ws_d"]), h2)
        return x + routed + shared, cache, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + rows(lambda hb: L.gated_mlp(
        hb, p["wg"], p["wu"], p["wd"]), h2), cache, aux


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
        layout(cfg), lambda kind: mla_cache_specs(cfg, batch, max_len))


def _run_stack(cfg, params, x, positions, cache, mode, pos=None,
               dist=None):
    """The stack, then the final norm: (x, aux-loss sum, cache).  In train
    mode each layer is recomputed in the backward pass when
    ``cfg.remat == "block"`` (the aux terms are taken in the forward, and
    a recomputation's appends go unread)."""
    aux = []

    def apply_slot(kind, p, xx, c):
        xx, c, a = slot_apply(cfg, kind, p, xx, c, positions, mode, pos,
                              dist)
        aux.append(a)
        return xx, c

    x, cache = S.apply_stack(params["stack"], x, layout(cfg), apply_slot,
                             cache=cache,
                             remat=mode == "train" and cfg.remat == "block")
    x = _rows(mode)(lambda xb: L.rms_norm(xb, params["ln_f"],
                                          cfg.norm_eps), x)
    return x, torch.stack(aux).sum(), cache


def forward_train(params, batch, cfg: ArchConfig, dist=None):
    """Next-token loss of ``batch["tokens"]`` (B, S) (masked by
    ``batch["loss_mask"]`` (B, S - 1) if given) plus ``ROUTER_AUX_COEF``
    times the summed switch aux loss; returns (loss, {"loss", "xent",
    "router_aux"}), differentiable in ``params``.  ``dist`` shards the
    routed experts (see :func:`moe_ffn`)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = L.embed(tokens, params["embed"])
    x, aux, _ = _run_stack(cfg, params, x, positions, None, "train",
                           dist=dist)
    xent = L.lm_head_loss(x[:, :-1], params["unembed"], tokens[:, 1:],
                          batch.get("loss_mask"))
    loss = xent + ROUTER_AUX_COEF * aux
    return loss, {"loss": loss, "xent": xent, "router_aux": aux}


@torch.no_grad()
def prefill(params, batch, cfg: ArchConfig, max_len: int, dist=None):
    """Exact (unpadded) prefill: returns (last-token logits (B, V) f32,
    the filled latent cache)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    cache = C.init_cache(cache_specs(cfg, b, max_len), dev)
    x = L.embed(tokens, params["embed"])
    x, _, cache = _run_stack(cfg, params, x, positions, cache, "prefill",
                             dist=dist)
    logits = L.unembed(x[:, -1:], params["unembed"])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, cache, batch, pos, cfg: ArchConfig, dist=None,
                fault_ctx=None):
    """batch["tokens"]: (B, 1); ``pos``: a scalar absolute position or a
    (B,) per-row position tensor (rows at a negative position skip their
    ring write).  Returns ((B, V) logits, the cache written in place).
    ``fault_ctx`` must be None: this family has no read path, so faults
    ride the write path."""
    if fault_ctx is not None:
        raise ValueError(
            f"family {cfg.family!r} has no read path (no "
            "SUPPORTS_READ_PATH): its faults ride the write path")
    tokens = batch["tokens"]
    b = tokens.shape[0]
    positions = C.decode_positions(pos, b, 1, tokens.device)
    x = L.embed(tokens, params["embed"])
    x, _, cache = _run_stack(cfg, params, x, positions, cache, "decode",
                             pos=pos, dist=dist)
    logits = L.unembed(x, params["unembed"])
    return logits[:, 0], cache


# MLA's head-split projections and the contraction dims of their inputs
# (counted from the leaf's end): the init rule's fan-in is the second-
# to-last dim, which for these 3-D leaves is the head count (or the head
# width), not the width they contract.
MLA_CONTRACTED = {"w_q": (-3,), "w_uq": (-3,), "w_uk": (-3,),
                  "w_uv": (-3,), "w_o": (-3, -2)}


@torch.no_grad()
def mla_fan_in_init(params) -> None:
    """Rescale, in place, MLA's head-split projections of a seeded init to
    std ``1 / sqrt(contracted width)``.  The init rule draws them with the
    head count as fan-in: at full width q and k come out ~11x too wide,
    the attention softmax saturates and the loss does not fall."""
    for path, leaf in pytree.flatten_with_path(params):
        dims = MLA_CONTRACTED.get(path[-1])
        if dims is None:
            continue
        width = math.prod(leaf.shape[d] for d in dims)
        leaf.mul_(math.sqrt(leaf.shape[-2] / width))


def routing_frequency(params, tokens, cfg: ArchConfig) -> np.ndarray:
    """Per-expert routing frequency over a probe token batch.

    The criticality probe of expert-weight placement: embeds the tokens
    and runs every MoE layer's router on the *embeddings* (the reference's
    approximation: no cache, no attention).  Returns a float64
    (n_experts,) vector summing to 1; frequently routed experts go to the
    safer tiers."""
    table = params["embed"]
    x = L.embed(torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                                device=table.device), table).float()
    counts = np.zeros(cfg.n_experts, np.float64)
    groups = [g for c in ("prefix", "periods", "rest")
              for g in params["stack"].get(c, {}).values()]
    with torch.no_grad():
        for grp in groups:
            if "w_router" not in grp:
                continue
            wr = grp["w_router"].float()      # (layers, d, e) or (d, e)
            if wr.dim() == 2:
                wr = wr[None]
            logits = torch.einsum("bsd,lde->lbse", x, wr)
            _, top_e = _top_k(logits, cfg.top_k)
            hot = top_e.reshape(-1).cpu().numpy()
            counts += np.bincount(hot, minlength=cfg.n_experts)
    total = counts.sum()
    return counts / total if total else counts + 1.0 / cfg.n_experts
