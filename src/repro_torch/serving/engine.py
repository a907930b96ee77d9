"""Batched serving engine: prefill + an eager decode loop (port of
:mod:`repro.serving.engine`).

KV-cache injection modes (``ServeConfig.kv_injection``):

  * ``'read'``   -- the K3 kernel corrupts K/V tiles as attention loads
    them; the write path covers only the ``pos`` bookkeeping leaves.
  * ``'write'``  -- the whole cache is injected once after prefill (K1,
    or K2 on an ECC domain), then each decode step corrupts only the slot
    it wrote (plain PyTorch, in place); attention reads the stored cache
    through K3 with injection off.
  * ``'rewrite'`` -- the whole cache is re-injected after every token
    (the slow cross-validation oracle).
  * ``'auto'``   -- ``'read'`` when the family and cache support it.

All modes route attention through K3 whenever faults may flow, so they
share one set of attention numerics and emit identical tokens: stuck-at
masks are deterministic per physical word and idempotent.  A clean cache
takes plain attention, or K3 without injection when
``ServeConfig.kv_tile`` names a tile.

``generate(kv_placement=...)`` replays one request of the paged
scheduler (:mod:`repro_torch.serving.scheduler`) on its own pages: the
placement's page tables address the same physical words and pin K3's
tile to one page, so the replay gives the scheduler's tokens.

The reference's bucketed prefill is a compile-count device of XLA; the
port runs the exact prefill, eagerly.  Its scanned decode becomes one
decode step captured as a CUDA graph
(:class:`~repro_torch.serving.captured.CapturedStep`): step 0 runs
eagerly as the warm-up, steps 1..n-1 replay the graph.  The graph holds
the model step, the write-path injection of every mode (K1 / K2 once per
step in rewrite mode) and, for greedy decode, the argmax; the position
buffer advances on the device.  Sampled decode samples outside the graph
from the request's generator, so its draws are those of the eager loop.
On the CPU the same step body runs eagerly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core import engine as arena
from repro_torch.core import pytree
from repro_torch.core.domains import leaf_words
from repro_torch.core.engine import resolve_method
from repro_torch.core.faultmodel import V_MIN
from repro_torch.core.injection import inject_group
from repro_torch.models.base import (ArchBundle, ArchConfig, cache_slot_axes,
                                     spec_avals)
from repro_torch.serving import readpath
from repro_torch.serving.captured import CapturedStep
from repro_torch.training.undervolt import UndervoltPlan


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    max_new_tokens: int = 32
    temperature: float = 0.0
    undervolt: Optional[UndervoltPlan] = None
    # Per-request KV-domain voltage override (a Python float).
    kv_voltage: Optional[float] = None
    kv_method: str = "auto"
    # Admission governor (repro_torch.training.governor.VoltageGovernor):
    # generate() serves at ``governor.admit(KV bytes)``, the paged
    # scheduler re-plans the pool's voltage at every admission.
    governor: Optional[object] = None
    kv_injection: str = "auto"
    # Continuous-batching scheduler knobs (ignored by generate()): prompt
    # tokens a prefilling slot consumes per serving step, copy-on-write
    # prompt-prefix sharing, and the observability plane
    # (repro_torch.obs.ObsConfig; None = the scheduler's default, on).
    prefill_chunk: int = 8
    share_prefix: bool = False
    obs: Optional[object] = None
    # Clean caches only: None keeps plain decode attention; a tile size
    # routes clean decode through K3 with injection off at that tile --
    # what the paged scheduler's K4 computes on a clean pool of pages of
    # that many slots.
    kv_tile: Optional[int] = None


def _kv_placement(bundle, cfg, batch_size, sc):
    if sc.undervolt is None or not sc.undervolt.enabled:
        return None, None
    if not sc.undervolt.covers("kv_cache"):
        return None, None
    cache_avals = spec_avals(
        bundle.module.cache_specs(cfg, batch_size, sc.max_len))
    placement = sc.undervolt.place({"kv_cache": cache_avals})["kv_cache"]
    return placement, cache_avals


def sample_tokens(logits, temperature: float,
                  generator: Optional[torch.Generator] = None):
    """Greedy / temperature sampling over (B, vocab) logits.

    Greedy takes the first maximum, NaN counting as the maximum (as
    ``jnp.argmax`` does).  Sampling is Gumbel-max with noise from
    ``generator``; it does not reproduce the reference's threefry draws."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits / temperature + gumbel, dim=-1).to(torch.int32)


@dataclasses.dataclass
class DecodeEngine:
    """Everything static about one request shape's decode phase."""

    mode: str                    # read | write | rewrite
    method: str
    active: bool                 # may this request inject at all
    use_fused: bool              # attention routed through K3
    n_more: int
    init_inject: Callable[[Any], Any]          # cache -> cache
    make_ctx: Callable[[], Any]                # -> ReadPathCtx | None
    step: Callable[..., Any]     # (params, cache, tok, pos, ctx) -> (logits, cache)


def _check_replay_placement(kvp, cache_avals, batch_size, sc) -> None:
    words = {pytree.keystr(p): leaf_words(a)
             for p, a in pytree.flatten_with_path(cache_avals)}
    for lp in kvp.leaves:
        if words.get(lp.path) != lp.n_words:
            raise ValueError(
                f"kv_placement does not fit this request's cache: leaf "
                f"{lp.path} places {lp.n_words} words but the (batch="
                f"{batch_size}, max_len={sc.max_len}) cache holds "
                f"{words.get(lp.path)} -- placements exported by the paged "
                "pool describe a single request (batch 1) at the pool's "
                "max_len")


def _check_replay_plan(sc: ServeConfig) -> None:
    if sc.undervolt is None or not sc.undervolt.enabled:
        raise ValueError(
            "kv_placement override needs sc.undervolt (its fault map "
            "supplies the placement's threshold tables)")


def build_decode_engine(bundle: ArchBundle, cfg: ArchConfig,
                        sc: ServeConfig, batch_size: int, *,
                        static_voltage: float, device,
                        kv_placement=None) -> DecodeEngine:
    """Construct the decode-phase closures for one request shape at the
    effective KV voltage ``static_voltage``.  ``kv_placement`` overrides
    the plan's own cache allocation (a paged scheduler request's
    page-granular placement)."""
    module = bundle.module
    if kv_placement is not None:
        _check_replay_plan(sc)
        kvp = kv_placement
        cache_avals = spec_avals(
            module.cache_specs(cfg, batch_size, sc.max_len))
        _check_replay_placement(kvp, cache_avals, batch_size, sc)
    else:
        kvp, cache_avals = _kv_placement(bundle, cfg, batch_size, sc)
    fmap = sc.undervolt.fault_map() if kvp is not None else None
    paged_kvp = kvp is not None and arena._is_paged(kvp)
    if sc.kv_injection not in ("auto", "read", "write", "rewrite"):
        raise ValueError(f"unknown kv_injection {sc.kv_injection!r}")
    if paged_kvp and sc.kv_injection == "rewrite":
        raise ValueError(
            "kv_injection='rewrite' (the full-cache re-injection oracle) "
            "does not replay a page-granular placement; use 'read' or "
            "'write' with paged placements")
    v = float(static_voltage)
    active = kvp is not None and v < V_MIN - 1e-9
    supports_read = (active and readpath.supports(module)
                     and readpath.cache_supported(kvp, cache_avals))
    mode = sc.kv_injection
    if mode == "auto":
        mode = "read" if supports_read else "write"
    if mode == "read" and active and not supports_read:
        raise ValueError(
            "kv_injection='read' needs a family with read-path support "
            "and word-aligned K/V slots; use 'write' or 'rewrite'")
    method = sc.kv_method
    if active and method == "auto":
        method = "word" if kvp.domain.ecc else resolve_method(fmap, kvp, v)
    use_fused = active and supports_read
    clean_tiled = (not active and sc.kv_tile is not None
                   and readpath.supports(module))
    slot_axes = (cache_slot_axes(
        module.cache_specs(cfg, batch_size, sc.max_len)) if active else None)

    def make_ctx():
        if use_fused:
            return readpath.build_ctx(kvp, fmap, cache_avals, voltage=v,
                                      method=method,
                                      inject=(mode == "read"), device=device)
        if clean_tiled:
            return readpath.build_clean_ctx(
                spec_avals(module.cache_specs(cfg, batch_size, sc.max_len)),
                bkv=sc.kv_tile, device=device)
        return None

    def init_inject(c):
        """Post-prefill injection (the cache's first trip to HBM)."""
        if not active:
            return c
        if mode == "read":
            c, _ = arena.inject_placement_slice(
                c, kvp, fmap, voltage=v, method=method,
                skip_paths=readpath.kv_paths(kvp))
            return c
        if paged_kvp:
            # whole-leaf write-path injection through the page tables
            c, _ = arena.inject_placement_slice(c, kvp, fmap, voltage=v,
                                                method=method)
            return c
        c, _ = inject_group(c, kvp, fmap, voltage=v, method=method)
        return c

    def post_inject(c, pos):
        """Write-path injection after a decode step wrote slot pos % L, in
        place (``pos`` an int or a (B,) tensor on the cache's device)."""
        if not active:
            return c
        if mode == "rewrite":
            faulted, _ = inject_group(c, kvp, fmap, voltage=v, method=method)
            for dst, src in zip(pytree.leaves(c), pytree.leaves(faulted)):
                dst.copy_(src)
            return c
        skip = readpath.kv_paths(kvp) if mode == "read" else ()
        c, _ = arena.inject_placement_slice(
            c, kvp, fmap, slot_axes=slot_axes, pos=pos, voltage=v,
            method=method, skip_paths=skip)
        return c

    def step(p, c, tok, pos, ctx):
        logits, c = module.decode_step(p, c, {"tokens": tok}, pos, cfg,
                                       fault_ctx=ctx)
        return logits, post_inject(c, pos)

    return DecodeEngine(mode=mode, method=method, active=active,
                        use_fused=use_fused,
                        n_more=sc.max_new_tokens - 1,
                        init_inject=init_inject, make_ctx=make_ctx,
                        step=step)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _admit(sc: ServeConfig, placement) -> float:
    """``ServeConfig.governor``'s voltage for a KV placement, after the
    reference's checks."""
    if sc.kv_voltage is not None:
        raise ValueError(
            "ServeConfig.governor and kv_voltage are mutually exclusive "
            "voltage controls")
    if sc.undervolt is None or sc.governor.plan is not sc.undervolt:
        raise ValueError(
            "sc.governor must be built from sc.undervolt (its "
            "frontier/capacity tables belong to that plan's fault map and "
            "domains)")
    if placement is None:
        raise ValueError(
            "ServeConfig.governor is set but the undervolt plan does not "
            "place 'kv_cache' (or is disabled): admission governance would "
            "silently be a no-op")
    kv_domain = placement.domain.name
    if sc.governor.config.domain != kv_domain:
        raise ValueError(
            f"sc.governor governs domain {sc.governor.config.domain!r} but "
            f"the KV cache is placed in domain {kv_domain!r}")
    return sc.governor.admit(placement.total_words * 4)


@torch.no_grad()
def generate(bundle: ArchBundle, cfg: ArchConfig, params, batch: Dict,
             sc: ServeConfig, *, device="cuda",
             generator: Optional[torch.Generator] = None,
             kv_placement=None,
             timings: Optional[Dict[str, float]] = None,
             capture: bool = True) -> torch.Tensor:
    """Prefill on batch['tokens'] then decode ``max_new_tokens`` tokens.

    ``params`` must live on ``device``.  ``generator`` drives sampled
    decode (temperature > 0); a fresh one seeded 0 is used if omitted.
    ``kv_placement`` replays a paged scheduler request on its own pages
    (``results[rid].placement``).  ``capture=False`` runs every decode
    step of a CUDA device eagerly (the captured step's yardstick; the
    tokens are the same).
    ``timings``, when given, receives host wall times (seconds, device
    synchronised) of ``prefill``, ``inject`` (the post-prefill injection
    and read-path context, once per request) and ``decode`` (the decode
    loop alone), ``steps``, the list of each decode step's time (the
    device synchronised after every step: step 0 is the warm-up, step 1
    captures the graph, the rest replay it), plus the ``mode``.
    Returns (B, max_new_tokens) int32 tokens."""
    dev = resolve_device(device)
    if kv_placement is not None and sc.governor is not None:
        raise ValueError(
            "kv_placement and ServeConfig.governor are mutually exclusive: "
            "the placement is already decided, so there is no admission "
            "to govern")
    tokens = torch.as_tensor(batch["tokens"]).to(device=dev,
                                                 dtype=torch.int64)
    b, s = tokens.shape
    if kv_placement is not None:
        _check_replay_plan(sc)
    placement = (kv_placement if kv_placement is not None
                 else _kv_placement(bundle, cfg, b, sc)[0])
    if sc.governor is not None:
        # Admission-time plan: the deepest voltage at which the governed
        # domain keeps this request's cache bytes usable, then the
        # fixed-voltage route at that voltage.
        sc = dataclasses.replace(sc, kv_voltage=_admit(sc, placement),
                                 governor=None)
    eff_v = sc.kv_voltage if sc.kv_voltage is not None else (
        placement.domain.voltage if placement is not None else V_MIN)
    eng = build_decode_engine(bundle, cfg, sc, b, static_voltage=eff_v,
                              device=dev, kv_placement=kv_placement)
    if generator is None and sc.temperature > 0.0:
        generator = torch.Generator(device=dev).manual_seed(0)

    t0 = time.perf_counter()
    logits, cache = bundle.module.prefill(params, {"tokens": tokens}, cfg,
                                          sc.max_len)
    tok = sample_tokens(logits, sc.temperature, generator)[:, None]
    if timings is not None:
        _sync(dev)
        timings["prefill"] = time.perf_counter() - t0
        timings["mode"] = eng.mode if eng.active else "clean"
    t1 = time.perf_counter()
    cache = eng.init_inject(cache)
    ctx = eng.make_ctx()
    if timings is not None:
        _sync(dev)
        timings["inject"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    result = torch.empty((b, 1 + eng.n_more), dtype=torch.int32, device=dev)
    result[:, 0] = tok[:, 0]
    tok_in = tok.long()
    pos = torch.full((b,), s, dtype=torch.int32, device=dev)
    greedy = sc.temperature <= 0.0

    def body():
        logits, _ = eng.step(params, cache, tok_in, pos, ctx)
        pos.add_(1)
        if greedy:
            tok_in.copy_(sample_tokens(logits, 0.0)[:, None])
            return tok_in
        return logits

    step = CapturedStep(body, dev, capture=capture)
    steps = []
    for i in range(eng.n_more):
        t2 = time.perf_counter()
        got = step()
        if not greedy:
            tok_in.copy_(
                sample_tokens(got, sc.temperature, generator)[:, None])
        result[:, i + 1] = tok_in[:, 0]
        if timings is not None:
            _sync(dev)
            steps.append(time.perf_counter() - t2)
    if timings is not None:
        _sync(dev)
        timings["decode"] = time.perf_counter() - t1
        timings["steps"] = steps
    return result
