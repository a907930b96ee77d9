"""xLSTM family: alternating mLSTM (matrix memory) and sLSTM blocks (port
of :mod:`repro.models.xlstm`).

mLSTM runs in *chunked* form over a prompt -- linear-attention math
inside a chunk of CHUNK steps, a (B, H, Dh, Dh) matrix memory carried
between chunks -- with the reference's sigmoid input / forget gates.  A
decode step (one token) takes the same math without the chunk's padding
rows (:func:`_mlstm_step`): the reference pads the token to a CHUNK-row
chunk whose pad rows (q = k = v = 0, i = 0, f = 1) add exact zeros, so
the two routes compute the same sums.  sLSTM keeps the exact stabilised
exponential gating and walks its recurrence one step at a time
(:func:`_slstm_scan`).  Every decode-state leaf (``mem``, ``norm``,
``conv``, ``h``, ``c``, ``n``, ``m``) is slotless carried ``state``:
the serving write path corrupts it whole every step.  Caches are written
in place.

Row invariance: the row-wise stages (norms, projections, gates, MLP,
output head) run through :func:`layers.row_blocked`, and the recurrent
products of a decode step (the mLSTM memory read, the sLSTM recurrent
matrices) run one batch row at a time with operations of one shape, so a
state-arena slot row gets the bits it gets decoded alone.  A prompt's
chunked mLSTM and stepwise sLSTM products run over the whole batch
(admission prefills one request; no comparison crosses prefill batch
shapes).

Training (:func:`forward_train`) runs the same chunked and stepwise math
with whole-tensor projections, which autograd differentiates.  This
family launches no kernel of its own: the reference's model has no Pallas
call, and its serving path reaches K1 / K2 through the write path's
``inject_group``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models import cache as C
from repro_torch.models import layers as L
from repro_torch.models import stack as S
from repro_torch.models.base import ArchConfig, ParamSpec

CHUNK = 128
_GATES = ("z", "i", "f", "o")


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, dt = cfg.d_model, cfg.dtype
    di = d                      # inner width (projection factor 2 -> 2*di up)
    h = cfg.n_heads
    return {
        "ln": ParamSpec((d,), (None,), dt, "zeros"),
        "w_up": ParamSpec((d, 2 * di), ("embed", "mlp"), dt),
        "conv_w": ParamSpec((cfg.conv_width, di), (None, "mlp"), dt),
        "conv_b": ParamSpec((di,), ("mlp",), dt, "zeros"),
        "w_q": ParamSpec((di, di), ("mlp", "heads"), dt),
        "w_k": ParamSpec((di, di), ("mlp", "heads"), dt),
        "w_v": ParamSpec((di, di), ("mlp", "heads"), dt),
        "w_ig": ParamSpec((di, h), ("mlp", None), dt),
        "b_ig": ParamSpec((h,), (None,), dt, "zeros"),
        "w_fg": ParamSpec((di, h), ("mlp", None), dt),
        # forget-gate bias init +3 => decay ~0.95: stable long memory
        "b_fg": ParamSpec((h,), (None,), dt, "const", scale=3.0),
        "w_down": ParamSpec((di, d), ("mlp", "embed"), dt),
    }


def mlstm_cache_specs(cfg: ArchConfig, batch: int) -> Dict[str, ParamSpec]:
    di = cfg.d_model
    h = cfg.n_heads
    dh = di // h
    return {
        "mem": ParamSpec((batch, h, dh, dh), ("batch", "heads", None, None),
                         torch.float32, "zeros"),
        "norm": ParamSpec((batch, h, dh), ("batch", "heads", None),
                          torch.float32, "zeros"),
        "conv": ParamSpec((batch, cfg.conv_width - 1, di),
                          ("batch", None, "mlp"), cfg.dtype, "zeros"),
    }


def _mlstm_chunked(q, k, v, i_g, f_g, mem0, n0):
    """Chunked gated linear attention (the reference's scan body, chunk by
    chunk).

    q/k/v: (B, S, H, Dh); i_g/f_g: (B, S, H) in (0, 1); mem0: (B, H, Dh,
    Dh) float32; n0: (B, H, Dh) float32.  Returns (out (B, S, H, Dh)
    float32, mem, n)."""
    b, s, h, dh = q.shape
    nc = -(-s // CHUNK)
    pad = nc * CHUNK - s
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        i_g = F.pad(i_g, (0, 0, 0, pad))
        f_g = F.pad(f_g, (0, 0, 0, pad), value=1.0)
    mask = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                 device=q.device))
    mem, n = mem0, n0
    outs = []
    for c in range(nc):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        fb, ib = f_g[:, sl].float(), i_g[:, sl].float()
        logf = torch.log(torch.clamp_min(fb, 1e-6))
        acc = torch.cumsum(logf, dim=1)              # (B, C, H)
        a_inc = torch.exp(acc)
        a_tot = torch.exp(acc[:, -1])                # (B, H)
        kb = k[:, sl].float()
        qf = q[:, sl].float() * a_inc[..., None]
        kf = kb * (ib / torch.clamp_min(a_inc, 1e-30))[..., None]
        vf = v[:, sl].float()
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        scores = torch.where(mask, scores, 0.0)
        intra = torch.einsum("bhqk,bkhd->bqhd", scores, vf)
        inter = torch.einsum("bqhd,bhde->bqhe", qf, mem)
        denom = scores.sum(dim=-1).transpose(1, 2)   # (B, C, H)
        denom = denom + torch.einsum("bqhd,bhd->bqh", qf, n)
        outs.append((intra + inter)
                    / torch.clamp_min(denom.abs()[..., None], 1.0))
        kw = kb * (ib * (a_tot[:, None] / torch.clamp_min(a_inc, 1e-30))
                   )[..., None]
        mem = mem * a_tot[..., None, None] + torch.einsum(
            "bkhd,bkhe->bhde", kw, vf)
        n = n * a_tot[..., None] + kw.sum(dim=1)
    out = torch.cat(outs, dim=1) if nc > 1 else outs[0]
    return out[:, :s], mem, n


def _mlstm_step(q, k, v, i_g, f_g, mem, n):
    """One decode step of one batch row: the chunked math of a single
    token (its chunk's pad rows add exact zeros), with operations of one
    shape whatever the batch.  q/k/v: (H, Dh); i_g/f_g: (H,); mem (H, Dh,
    Dh), n (H, Dh) float32.  Returns (out (H, Dh), mem, n)."""
    fb, ib = f_g.float(), i_g.float()
    a = torch.exp(torch.log(torch.clamp_min(fb, 1e-6)))      # a_inc == a_tot
    qf = q.float() * a[:, None]
    kb = k.float()
    kf = kb * (ib / torch.clamp_min(a, 1e-30))[:, None]
    vf = v.float()
    score = (qf * kf).sum(dim=-1)                            # (H,)
    inter = torch.bmm(qf[:, None, :], mem)[:, 0]             # (H, Dh)
    denom = score + (qf * n).sum(dim=-1)
    out = (score[:, None] * vf + inter) / torch.clamp_min(
        denom.abs()[:, None], 1.0)
    kw = kb * (ib * (a / torch.clamp_min(a, 1e-30)))[:, None]
    mem = mem * a[:, None, None] + kw[:, :, None] * vf[:, None, :]
    n = n * a[:, None] + kw
    return out, mem, n


def _mlstm_inputs(cfg: ArchConfig, p, x, tail, serving: bool):
    """Norm, up projection, causal conv and the q/k/v/gate projections.
    Returns (q, k, v, i_g, f_g, z, new conv tail)."""
    b, s, d = x.shape
    h = cfg.n_heads
    di = d
    dh = di // h

    def up(xb):
        return L.rms_norm(xb, p["ln"], cfg.norm_eps) @ p["w_up"]

    u = L.row_blocked(up, x) if serving else up(x)
    xm, z = u[..., :di], u[..., di:]
    if tail is None:
        tail = xm.new_zeros((b, cfg.conv_width - 1, di))
    xm, new_tail = L.causal_conv(xm, p["conv_w"], p["conv_b"], tail)
    xm = F.silu(xm)

    def proj(mb):
        return (mb @ p["w_q"], mb @ p["w_k"], mb @ p["w_v"],
                torch.sigmoid(mb @ p["w_ig"] + p["b_ig"]),
                torch.sigmoid(mb @ p["w_fg"] + p["b_fg"]))

    q, k, v, i_g, f_g = L.row_blocked(proj, xm) if serving else proj(xm)
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, h, dh) * (dh ** -0.5)
    v = v.reshape(b, s, h, dh)
    return q, k, v, i_g, f_g, z, new_tail


def mlstm_apply(cfg: ArchConfig, p, x, cache):
    """One mLSTM block of the serving paths; the new memory, normaliser
    and conv tail are written into ``cache`` in place."""
    b, s, d = x.shape
    q, k, v, i_g, f_g, z, new_tail = _mlstm_inputs(cfg, p, x,
                                                   cache["conv"], True)
    if s == 1:
        outs = []
        for bi in range(b):
            o, m_, n_ = _mlstm_step(q[bi, 0], k[bi, 0], v[bi, 0],
                                    i_g[bi, 0], f_g[bi, 0],
                                    cache["mem"][bi], cache["norm"][bi])
            cache["mem"][bi].copy_(m_)
            cache["norm"][bi].copy_(n_)
            outs.append(o)
        out = torch.stack(outs)[:, None]
    else:
        out, mem, n = _mlstm_chunked(q, k, v, i_g, f_g, cache["mem"],
                                     cache["norm"])
        cache["mem"].copy_(mem)
        cache["norm"].copy_(n)
    cache["conv"].copy_(new_tail)
    gated = out.reshape(b, s, d).to(x.dtype) * F.silu(z)
    return x + L.row_blocked(lambda gb: gb @ p["w_down"], gated), cache


def _mlstm_train(cfg: ArchConfig, p, x):
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    q, k, v, i_g, f_g, z, _ = _mlstm_inputs(cfg, p, x, None, False)
    zeros = x.new_zeros((b, h, dh, dh), dtype=torch.float32)
    out, _, _ = _mlstm_chunked(q, k, v, i_g, f_g, zeros, zeros[..., 0])
    out = out.reshape(b, s, d).to(x.dtype) * F.silu(z)
    return x + out @ p["w_down"]


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def slstm_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, dt = cfg.d_model, cfg.dtype
    h = cfg.n_heads
    dh = d // h
    f_mlp = int(4 * d / 3)
    gates = {}
    for g in _GATES:
        gates[f"w_{g}"] = ParamSpec((d, d), ("embed", "mlp"), dt)
        gates[f"r_{g}"] = ParamSpec((h, dh, dh), ("heads", None, None), dt)
        gates[f"b_{g}"] = ParamSpec(
            (d,), (None,), dt, "const" if g == "f" else "zeros",
            scale=3.0 if g == "f" else 1.0)
    return {
        "ln": ParamSpec((d,), (None,), dt, "zeros"),
        **gates,
        "w_out": ParamSpec((d, d), ("mlp", "embed"), dt),
        "ln2": ParamSpec((d,), (None,), dt, "zeros"),
        "wg": ParamSpec((d, f_mlp), ("embed", "mlp"), dt),
        "wu": ParamSpec((d, f_mlp), ("embed", "mlp"), dt),
        "wd": ParamSpec((f_mlp, d), ("mlp", "embed"), dt),
    }


def slstm_cache_specs(cfg: ArchConfig, batch: int) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    return {k: ParamSpec((batch, d), ("batch", "mlp"), torch.float32, "zeros")
            for k in ("h", "c", "n", "m")}


def _slstm_scan(xz, xi, xf, xo, p, state, n_heads, per_row: bool = False):
    """Stabilised exponential-gating sLSTM recurrence over time.

    x?: (B, S, D) preactivations (input contributions); state: dict of
    (B, D) float32 ``h``, ``c``, ``n``, ``m``.  Block-diagonal recurrent
    weights per head.  With ``per_row`` (a serving decode step) every
    row's (H, 1, Dh) state is multiplied by the (H, Dh, 4 Dh) gate
    matrices on its own, so a row's bits do not depend on the batch; a
    prompt or a training batch is multiplied at once.  A step is 15
    device ops: a prompt walks them S times per layer, eagerly.  Returns
    (hs (B, S, D) float32, the final state dict)."""
    b, s, d = xz.shape
    dh = d // n_heads
    # (H, Dh, 4 Dh): the z, i, f, o recurrent matrices side by side
    rmat = torch.cat([p[f"r_{g}"] for g in _GATES], dim=-1).float()
    # preactivations and state in (S, H, B, *) / (H, B, Dh) layout
    pre = torch.stack([t.float().reshape(b, s, n_heads, dh)
                       for t in (xz, xi, xf, xo)], dim=3)
    pre = pre.permute(1, 2, 0, 3, 4).reshape(s, n_heads, b, 4 * dh)

    def heads(t):
        return t.reshape(b, n_heads, dh).transpose(0, 1)

    h, c, n, m = (heads(state[k]) for k in ("h", "c", "n", "m"))
    hs = []
    for t in range(s):
        if per_row and b > 1:
            rec = torch.cat([torch.bmm(h[:, bi:bi + 1], rmat)
                             for bi in range(b)], dim=1)
        else:
            rec = torch.bmm(h, rmat)                 # (H, B, 4 Dh)
        g = rec.add_(pre[t])
        g_f = g[..., 2 * dh:3 * dh]
        g_f.add_(m)                                  # f_t + m
        m = torch.maximum(g_f, g[..., dh:2 * dh])
        # exp(i_t - m_new) and exp(f_t + m - m_new) in one pass
        e = torch.exp(g[..., dh:3 * dh].unflatten(-1, (2, dh))
                      - m[..., None, :])
        i_p, f_p = e[..., 0, :], e[..., 1, :]
        c = torch.addcmul(f_p * c, i_p, torch.tanh(g[..., :dh]))
        n = torch.addcmul(i_p, f_p, n)
        h = torch.sigmoid(g[..., 3 * dh:]) * (c / torch.clamp_min(n.abs(),
                                                                  1.0))
        hs.append(h)

    def rows(t):
        return t.transpose(0, 1).reshape(b, d)

    out = torch.stack(hs).permute(2, 0, 1, 3).reshape(b, s, d)
    return out, {"h": rows(h), "c": rows(c), "n": rows(n), "m": rows(m)}


def _slstm_pre(cfg: ArchConfig, p, x, serving: bool):
    def pre(xb):
        xn = L.rms_norm(xb, p["ln"], cfg.norm_eps)
        return tuple(xn @ p[f"w_{g}"] + p[f"b_{g}"] for g in _GATES)

    return L.row_blocked(pre, x) if serving else pre(x)


def slstm_apply(cfg: ArchConfig, p, x, cache):
    """One sLSTM block of the serving paths; the new (h, c, n, m) are
    written into ``cache`` in place."""
    zp, ip, fp, op = _slstm_pre(cfg, p, x, True)
    hs, new = _slstm_scan(zp, ip, fp, op, p, cache, cfg.n_heads,
                          per_row=x.shape[1] == 1)
    for k, t in new.items():
        cache[k].copy_(t)
    x = x + L.row_blocked(lambda hb: hb @ p["w_out"], hs.to(x.dtype))
    return x + L.row_blocked(lambda xb: L.gated_mlp(
        L.rms_norm(xb, p["ln2"], cfg.norm_eps), p["wg"], p["wu"], p["wd"],
        act="gelu"), x), cache


def _slstm_train(cfg: ArchConfig, p, x):
    b, _, d = x.shape
    zp, ip, fp, op = _slstm_pre(cfg, p, x, False)
    zeros = x.new_zeros((b, d), dtype=torch.float32)
    hs, _ = _slstm_scan(zp, ip, fp, op, p, {k: zeros for k in "hcnm"},
                        cfg.n_heads)
    x = x + hs.to(x.dtype) @ p["w_out"]
    return x + L.gated_mlp(L.rms_norm(x, p["ln2"], cfg.norm_eps), p["wg"],
                           p["wu"], p["wd"], act="gelu")


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------


def slot_specs(cfg: ArchConfig, kind: str):
    return mlstm_specs(cfg) if kind == "mlstm" else slstm_specs(cfg)


def slot_cache(cfg: ArchConfig, kind: str, batch: int):
    return (mlstm_cache_specs(cfg, batch) if kind == "mlstm"
            else slstm_cache_specs(cfg, batch))


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
    del max_len  # state size is context-independent
    return S.stack_cache_specs(
        layout(cfg), lambda kind: slot_cache(cfg, kind, batch))


def _run_stack(cfg, params, x, cache):
    def apply_slot(kind, p, xx, c):
        if kind == "mlstm":
            return mlstm_apply(cfg, p, xx, c)
        return slstm_apply(cfg, p, xx, c)

    x, cache = S.apply_stack(params["stack"], x, layout(cfg), apply_slot,
                             cache=cache)
    return L.row_blocked(lambda xb: L.rms_norm(xb, params["ln_f"],
                                               cfg.norm_eps), x), cache


def forward_train(params, batch, cfg: ArchConfig, dist=None):
    """Token-mean next-token loss of ``batch["tokens"]`` (B, S) (masked by
    ``batch["loss_mask"]`` if given); returns (loss, {"loss": loss}),
    differentiable in ``params``."""
    tokens = batch["tokens"]

    def apply_slot(kind, p, xx, c):
        if kind == "mlstm":
            return _mlstm_train(cfg, p, xx), c
        return _slstm_train(cfg, p, xx), c

    x = L.embed(tokens, params["embed"])
    x, _ = S.apply_stack(params["stack"], x, layout(cfg), apply_slot,
                         remat=cfg.remat == "block")
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    loss = L.lm_head_loss(x[:, :-1], params["unembed"], tokens[:, 1:],
                          batch.get("loss_mask"))
    return loss, {"loss": loss}


@torch.no_grad()
def prefill(params, batch, cfg: ArchConfig, max_len: int, dist=None):
    """Prefill: returns (last-token logits (B, V) float32, the state)."""
    tokens = batch["tokens"]
    cache = C.init_cache(cache_specs(cfg, tokens.shape[0], max_len),
                         tokens.device)
    x = L.embed(tokens, params["embed"])
    x, cache = _run_stack(cfg, params, x, cache)
    logits = L.unembed(x[:, -1:], params["unembed"])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(params, cache, batch, pos, cfg: ArchConfig, dist=None,
                fault_ctx=None):
    """batch["tokens"]: (B, 1); ``pos`` is not read (the state carries the
    context; rows at a negative position advance their state, as in the
    reference).  Returns ((B, V) logits, the state written in place).
    ``fault_ctx`` must be None: the state's faults ride the write path."""
    if fault_ctx is not None:
        raise ValueError(
            f"family {cfg.family!r} has no read path (no "
            "SUPPORTS_READ_PATH): its faults ride the write path")
    del pos
    x = L.embed(batch["tokens"], params["embed"])
    x, cache = _run_stack(cfg, params, x, cache)
    logits = L.unembed(x, params["unembed"])
    return logits[:, 0], cache
