"""State-arena continuous batching: the scheduler route for families whose
decode state does not page (port of :mod:`repro.serving.statearena`):
the recurrent-state hybrid family, the DeepSeek-V2 family's MLA latent
rings, xLSTM's matrix memories, whisper's decoder with its cross K/V and
the VLM wrapper.

``ContinuousBatchingScheduler(...)`` dispatches here, from ``__new__``,
for a family without ``SUPPORTS_PAGED``.  The whole per-slot cache tree
is batched along its ``batch`` axis (slot = batch row), and every step
advances all rows through one decode step with a per-row position
vector (-1 for a free slot, whose ring write is skipped).  That step is
one CUDA graph over all slot rows
(:class:`~repro_torch.serving.captured.CapturedStep`), captured once per
scheduler (``stats['decode_traces'] == 1``): tokens and positions are
static device buffers loaded from pinned host memory, liveness is the
device mask ``position >= 0``, and the per-slot placements, voltages and
methods, fixed at construction, are capture-time constants.  Admission
prefill (K7, K8) stays eager.

  * Admission runs ``generate()``'s own exact prefill on the request
    alone (batch 1), samples token 0 as ``generate()`` does, applies the
    standalone post-prefill ``init_inject`` (``inject_group`` on the
    slot's placement) and copies the (1, max_len) tree into the slot's
    row.
  * Placement is tiered arena placement per slot, fixed at construction:
    ``num_slots`` disjoint copies of the (batch=1, max_len) cache across
    the plan's domains at ``state_tier`` (default ``"cheap"``: carried
    state is fault tolerant), or the plan's ``kv_cache`` domain on a
    policy plan.
  * Carried state takes persistent faults: the step's per-slot
    write-path injection (``inject_placement_slice``) corrupts ring
    leaves at the slot just written but slotless ``state`` leaves whole,
    and since recurrent state is rewritten every step, the stuck-at masks
    re-apply to every new value -- a fault acquired on write persists for
    the life of the request.
  * Token equivalence: every request's tokens equal
    ``generate(..., kv_placement=results[rid].placement)`` -- the same
    prefill, the same ``inject_group`` init, the same post-step injection
    on the same placement, the same sampling generator -- because the
    model's row-wise stages and decode attention are row-invariant
    (:mod:`repro_torch.models.rglru`), so a row decoded beside others
    gets the bits it gets alone.

Extras (``Request.extras``): modality inputs beyond tokens -- whisper's
``frames``, the VLM's ``patches`` -- passed unbatched and admitted with a
leading batch axis, as ``generate()`` takes them.  The VLM's image tokens
occupy the front of the ring: its query positions start at ``prompt_len +
cfg.enc_len``, and ``max_len`` must hold them too.

Prefill reuse (``ServeConfig.share_prefix``): the admission prefill is
content-addressed -- identical (tokens, extras) bytes reuse the earlier
``(logits, cache)`` (repeated audio skips the encoder).  ``prefill_reuse``
counts the reuses, a reused admission has ``pages_shared`` 1 and its
admission event ``prefill_reused`` True.  The cached tree is only ever
read: the slot's ``inject_group`` makes a new tree and the copy into the
arena row reads it, so each slot takes the faults of its own placement
and none leaks into the next slot that reuses the result.

Refused here as in the reference (a ``ValueError``, or
:class:`~repro_torch.serving.scheduler.ShardLayoutError` for meshes):
serve meshes, self-healing and admission governors (they need the paged
pool), and ``kv_injection='read'`` / ``'rewrite'`` (no read-path kernel
addresses these layouts; ``'auto'`` resolves to ``'write'``).

MoE expert criticality tiering (``expert_probe=``): a probe token batch
drives the family's ``routing_frequency``; experts are ranked and placed
tiered (hot quarter ``safe``, cold quarter ``disposable``, the rest
``cheap``) through ``place_groups_tiered`` over the plan's domains, and
the experts placed below V_MIN are injected once at construction
(``inject_group``: one K1, or K2 on an ECC domain, launch per expert).
``stats["expert_tiers"]`` counts the tiers.  The reference's
``ValueError``s stand: a family without ``routing_frequency``, or no plan
placing ``kv_cache``.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import engine as arena
from repro_torch.core import pytree
from repro_torch.core.domains import place_groups, place_groups_tiered
from repro_torch.core.engine import resolve_method
from repro_torch.core.faultmodel import V_MIN, V_NOM
from repro_torch.core.injection import inject_group
from repro_torch.models import cache as C
from repro_torch.models.base import (ArchBundle, ArchConfig,
                                     cache_batch_axes, cache_layouts,
                                     cache_slot_axes, spec_avals)
from repro_torch.obs.metrics import (N_STEP_COUNTERS, MetricsRegistry,
                                     ObsConfig, init_step_counters)
from repro_torch.obs.trace import EventTrace
from repro_torch.serving import scheduler as _sched
from repro_torch.serving.captured import CapturedStep
from repro_torch.serving.engine import (ServeConfig, prompt_positions,
                                        sample_tokens)


def _batch_bytes(prompt, extras) -> bytes:
    """Content address of one admission: its tokens and extras (names,
    shapes, dtypes and bytes)."""
    parts = [np.asarray(prompt, np.int64)]
    parts += [np.asarray(extras[k]) for k in sorted(extras or {})]
    names = ["tokens"] + sorted(extras or {})
    return b"|".join(n.encode() + str(a.shape).encode() + str(a.dtype).encode()
                     + a.tobytes() for n, a in zip(names, parts))


def _rows(tree, axes, s: int):
    """Views of batch row ``s`` (kept as a length-1 axis) of every leaf."""
    out = pytree.tree_map(lambda x: x, tree)
    for (path, leaf), ax in zip(pytree.flatten_with_path(tree),
                                pytree.leaves(axes)):
        pytree.set_path(out, path, leaf.narrow(ax, s, 1))
    return out


class StateArenaScheduler(_sched.ContinuousBatchingScheduler):
    """Continuous batching over per-slot arena-placed whole caches.

    Built through ``ContinuousBatchingScheduler(...)``; ``num_pages`` and
    ``page_slots`` are accepted for the same signature and ignored (there
    is no page pool).  ``device`` holds the cache and runs the step
    (``params`` must live there)."""

    def __init__(self, bundle: ArchBundle, cfg: ArchConfig, params,
                 sc: ServeConfig, *, num_slots: int, num_pages: int = 0,
                 page_slots: int = 0, max_active: Optional[int] = None,
                 device="cuda", mesh=None, shard_seeds=None,
                 shard_setpoints=None, self_heal=None,
                 obs: Optional[ObsConfig] = None,
                 state_tier: Any = "cheap", expert_probe=None,
                 capture: bool = True):
        fam = getattr(cfg, "family", "?")
        if (mesh is not None or shard_seeds is not None
                or shard_setpoints is not None):
            raise _sched.ShardLayoutError(
                f"family {fam!r} serves through the state-arena route (no "
                "SUPPORTS_PAGED), which is single-shard: serve meshes "
                "partition the page pool, and this family's cache does not "
                "page")
        if self_heal is not None:
            raise ValueError(
                "self_heal needs paged read-mode caches (ECC telemetry and "
                "page migration address pool pages); the state-arena route "
                f"serving family {fam!r} has no page pool")
        if sc.governor is not None:
            raise ValueError(
                "ServeConfig.governor walks the paged pool's capacity "
                "frontier; the state-arena route has fixed per-slot "
                "placements decided at construction (re-plan by rebuilding "
                "the scheduler)")
        if sc.kv_injection == "rewrite":
            raise ValueError(
                "kv_injection='rewrite' is the one-shot re-injection oracle; "
                "the scheduler's step injects incrementally.  Use 'write' "
                "(or 'auto')")
        if sc.kv_injection == "read":
            raise ValueError(
                f"kv_injection='read' needs a family with read-path support; "
                f"family {fam!r} serves on the state-arena route where "
                "faults ride the write path ('write' or 'auto')")
        if sc.kv_injection not in ("auto", "write"):
            raise ValueError(f"unknown kv_injection {sc.kv_injection!r}")
        self.bundle, self.cfg, self.params, self.sc = bundle, cfg, params, sc
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.max_active = int(num_slots if max_active is None
                              else max_active)
        if self.num_slots < 1 or not 1 <= self.max_active <= self.num_slots:
            raise ValueError(f"need 1 <= max_active ({self.max_active}) <= "
                             f"num_slots ({self.num_slots})")

        # ---- cache geometry --------------------------------------------
        module, S = bundle.module, self.num_slots
        specs1 = module.cache_specs(cfg, 1, sc.max_len)
        self.cache_avals1 = spec_avals(specs1)
        self.slot_axes1 = cache_slot_axes(specs1)
        self.batch_axes = cache_batch_axes(specs1)
        if min(pytree.leaves(self.batch_axes)) < 0:
            raise ValueError(
                f"family {fam!r} has a cache leaf without a 'batch' axis; "
                "the state arena slices per-request rows by that name")
        self.layout_kinds = tuple(sorted(set(pytree.leaves(
            cache_layouts(specs1, sc.max_len)))))

        # ---- per-slot arena placement (fixed at construction) ----------
        plan = (sc.undervolt if sc.undervolt is not None
                and sc.undervolt.enabled else None)
        self.state_tier = state_tier
        self.placements: List[Optional[Any]] = [None] * S
        self.fmap = None
        if plan is not None and plan.covers("kv_cache"):
            self.fmap = plan.fault_map()
            groups = {f"kv_cache[{i:04d}]": self.cache_avals1
                      for i in range(S)}
            if plan.tiers is not None:
                placed = place_groups_tiered(
                    groups, {g: state_tier for g in groups}, plan.domains,
                    plan.geometry, self.fmap)
            else:
                dname = plan.policy["kv_cache"]
                placed = place_groups(groups, {g: dname for g in groups},
                                      plan.domains, plan.geometry)
            self.placements = [placed[f"kv_cache[{i:04d}]"]
                               for i in range(S)]

        # ---- MoE expert criticality tiering ----------------------------
        self.plan = plan
        self.expert_tiers: Optional[Dict[int, str]] = None
        self.expert_freq = None
        self._expert_placements = None
        if expert_probe is not None:
            self._tier_experts(np.asarray(expert_probe, np.int64))

        # ---- per-slot voltage / method / liveness (as generate()) ------
        self._slot_volt: List[Optional[float]] = [None] * S
        self._slot_method: List[str] = ["word"] * S
        self._slot_live: List[bool] = [False] * S
        for i, plc in enumerate(self.placements):
            if plc is None:
                continue
            v = float(sc.kv_voltage if sc.kv_voltage is not None
                      else plc.domain.voltage)
            live = v < V_MIN - 1e-9
            meth = sc.kv_method
            if live and meth == "auto":
                meth = ("word" if plc.domain.ecc
                        else resolve_method(self.fmap, plc, v))
            self._slot_volt[i] = v
            self._slot_method[i] = meth
            self._slot_live[i] = live
        self.active = any(self._slot_live)

        # ---- host bookkeeping ------------------------------------------
        self.queue: collections.deque = collections.deque()
        self.results: Dict[Any, _sched.RequestResult] = {}
        self._slots: List[Optional[Any]] = [None] * S
        self._gen: List[Optional[torch.Generator]] = [None] * S
        self._qpos_h = [-1] * S
        self._tok_h = [0] * S
        self._out: Dict[Any, List[int]] = {}
        self._remaining: Dict[Any, int] = {}
        self._meta: Dict[Any, _sched.RequestResult] = {}
        self._admit_step: Dict[Any, int] = {}
        # share_prefix: admission bytes -> (logits, cache) of its prefill
        self._prefill_cache: Dict[bytes, Any] = {}
        self.prefill_reuse = 0
        self.steps = 0
        self.admitted = 0
        self.peak_active = 0
        # host wall seconds of each step (device synchronised by the
        # token read); every step of this route is a decode step
        self.step_seconds: Dict[str, List[float]] = {"decode": []}

        self.obs = (obs if obs is not None
                    else sc.obs if sc.obs is not None else ObsConfig())
        self.metrics: Optional[MetricsRegistry] = None
        self.trace: Optional[EventTrace] = None
        self.state = {"cache": C.init_cache(
            module.cache_specs(cfg, S, sc.max_len), self.device)}
        self._decode = CapturedStep(self._decode_body, self.device, inputs={
            "tok": torch.zeros((S, 1), dtype=torch.int64, device=self.device),
            "pos": torch.full((S,), -1, dtype=torch.int32,
                              device=self.device)}, capture=capture)
        if self.obs.enabled:
            self.metrics = MetricsRegistry(
                1, None, config=self.obs,
                kv_slot_bytes=self._step_write_bytes(),
                kv_page_bytes=self._slot_read_bytes(),
                layouts=self.layout_kinds)
            self.trace = EventTrace(capacity=self.obs.trace_capacity)
            self.state["mtr"] = init_step_counters(1)

    # ---- static byte geometry (obs) ------------------------------------
    def _payload_leaves(self):
        """(aval, slot axis) of every payload leaf (not ``pos``)."""
        for a, ax in zip(pytree.leaves(self.cache_avals1),
                         pytree.leaves(self.slot_axes1)):
            if a.dtype != torch.int32:
                yield a, ax

    def _step_write_bytes(self) -> int:
        """Bytes one active lane writes per step: one ring row per ring
        leaf, the whole leaf for carried state."""
        total = 0
        for a, ax in self._payload_leaves():
            nb = int(np.prod(a.shape)) * a.dtype.itemsize
            total += nb // a.shape[ax] if ax >= 0 else nb
        return total

    def _slot_read_bytes(self) -> int:
        """Bytes one active lane reads per step (its whole cache)."""
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize
                   for a, _ in self._payload_leaves())

    # ---- MoE expert tiering ----------------------------------------------
    def _tier_experts(self, probe: np.ndarray) -> None:
        """Rank the experts by ``routing_frequency`` over ``probe`` (stable
        on ties), place each expert's weight slices across every MoE layer
        group by tier (hot quarter ``safe``, cold quarter ``disposable``,
        the rest ``cheap``) and inject the experts placed below V_MIN once,
        here: expert weights are never rewritten, so those faults persist
        for the scheduler's lifetime.  ``self.params`` becomes a new tree
        whose expert leaves are corrupted copies (the caller's tensors are
        not written); a solo replay on ``sched.params`` gives the
        scheduler's tokens."""
        module, cfg, plan = self.bundle.module, self.cfg, self.plan
        if not hasattr(module, "routing_frequency") or not cfg.n_experts:
            raise ValueError(
                f"expert_probe given but family {cfg.family!r} has no "
                "routing_frequency (expert tiering is MoE-only)")
        if plan is None or self.fmap is None:
            raise ValueError(
                "expert_probe needs an enabled undervolt plan covering "
                "'kv_cache' (expert weights are placed on the same "
                "fault map as the per-slot caches)")
        freq = np.asarray(module.routing_frequency(
            self.params, probe.reshape(1, -1), cfg))
        e = cfg.n_experts
        order = np.argsort(-freq, kind="stable")
        quarter = max(e // 4, 1)
        tiers: Dict[int, str] = {}
        for rank, ex in enumerate(int(x) for x in order):
            tiers[ex] = ("safe" if rank < quarter
                         else "disposable" if rank >= e - quarter
                         else "cheap")
        # per-expert weight slices (views) across every MoE layer group
        trees: Dict[int, Dict[str, Any]] = {ex: {} for ex in range(e)}
        sites = []
        for cname in ("prefix", "periods", "rest"):
            for gkey, grp in self.params["stack"].get(cname, {}).items():
                if "we_g" not in grp:
                    continue
                for w in ("we_g", "we_u", "we_d"):
                    sites.append((cname, gkey, w))
                    for ex in range(e):
                        trees[ex][f"{cname}/{gkey}/{w}"] = \
                            grp[w][..., ex, :, :]
        name = "moe_expert[{:03d}]".format
        placed = place_groups_tiered(
            {name(ex): trees[ex] for ex in range(e)},
            {name(ex): tiers[ex] for ex in range(e)},
            plan.domains, plan.geometry, self.fmap)
        corrupted: Dict[int, Any] = {}
        for ex in range(e):
            plc = placed[name(ex)]
            v = plc.domain.voltage
            if v >= V_MIN - 1e-9:
                continue
            meth = ("word" if plc.domain.ecc
                    else resolve_method(self.fmap, plc, v))
            corrupted[ex], _ = inject_group(trees[ex], plc, self.fmap,
                                            voltage=v, method=meth)
        if corrupted:
            stack = {cn: dict(gr) for cn, gr in self.params["stack"].items()}
            for cn, gk, _ in sites:
                stack[cn][gk] = dict(stack[cn][gk])
            for cn, gk, w in sites:
                arr = stack[cn][gk][w].clone()
                for ex, tree in corrupted.items():
                    arr[..., ex, :, :] = tree[f"{cn}/{gk}/{w}"]
                stack[cn][gk][w] = arr
            self.params = {**self.params, "stack": stack}
        self.expert_tiers = tiers
        self.expert_freq = freq
        self._expert_placements = placed

    # ---- the step ------------------------------------------------------
    def _post_inject(self, cache, pos) -> None:
        """Per-slot write-path injection, in place: the standalone
        engine's post-step injection on each slot's own placement (ring
        leaves at the slot just written, carried state whole), for every
        slot whose voltage faults; a free slot (position -1 in the device
        buffer ``pos``) writes nothing."""
        for s in range(self.num_slots):
            if not self._slot_live[s]:
                continue
            arena.inject_placement_slice(
                _rows(cache, self.batch_axes, s), self.placements[s],
                self.fmap, slot_axes=self.slot_axes1, pos=pos[s],
                voltage=self._slot_volt[s], method=self._slot_method[s])

    def _decode_body(self):
        """One decode step of every slot row from the static buffers, the
        write-path injection and, greedy, the argmax.  Returns the (S,)
        tokens, or the (S, V) logits when sampling."""
        inp = self._decode.inputs
        logits, cache = self.bundle.module.decode_step(
            self.params, self.state["cache"], {"tokens": inp["tok"]},
            inp["pos"], self.cfg)
        if self.active:
            self._post_inject(cache, inp["pos"])
        if self.sc.temperature <= 0.0:
            return sample_tokens(logits, 0.0)
        return logits

    def _sample(self, out, rows) -> List[int]:
        if self.sc.temperature <= 0.0:
            toks = out.cpu().numpy()
            return [int(toks[s]) for s in rows]
        return [int(sample_tokens(out[s:s + 1], self.sc.temperature,
                                  self._gen[s])[0]) for s in rows]

    def step_once(self) -> None:
        """One decode step of every slot row (free rows at position -1)."""
        t0 = time.perf_counter()
        live = [s for s, rid in enumerate(self._slots) if rid is not None]
        self._decode.load(
            tok=np.asarray(self._tok_h, np.int64)[:, None],
            pos=np.asarray([self._qpos_h[s] if self._slots[s] is not None
                            else -1 for s in range(self.num_slots)],
                           np.int32))
        with torch.no_grad():
            toks = self._sample(self._decode(), live)
        seconds = time.perf_counter() - t0
        self.step_seconds["decode"].append(seconds)
        if self.metrics is not None:
            self.metrics.record_step(seconds)
            delta = torch.zeros((N_STEP_COUNTERS,), dtype=torch.int32)
            delta[0] = delta[2] = delta[3] = len(live)
            self.state["mtr"][0] += delta
        self.steps += 1
        for s, t in zip(live, toks):
            self._qpos_h[s] += 1
            self._collect(s, self._slots[s], t)

    # ---- host loop -----------------------------------------------------
    def submit(self, request: _sched.Request) -> None:
        n_new = (request.max_new_tokens
                 if request.max_new_tokens is not None
                 else self.sc.max_new_tokens)
        if int(n_new) < 1:
            raise ValueError(f"request {request.rid!r}: max_new_tokens="
                             f"{n_new} must be >= 1")
        plen = int(np.asarray(request.tokens).reshape(-1).shape[0])
        if plen < 1:
            raise ValueError(f"request {request.rid!r}: empty prompt")
        enc = prompt_positions(self.cfg, 0)
        if plen + enc + int(n_new) > self.sc.max_len:
            raise ValueError(
                f"request {request.rid!r}: prompt ({plen}) + "
                f"{'image tokens + ' if enc else ''}new tokens "
                f"({n_new}) exceed max_len={self.sc.max_len}; the "
                "state-arena ring holds the whole request")
        self.queue.append(request)

    def admit_pending(self) -> int:
        n = 0
        while self.queue and self.n_active < self.max_active:
            s = self._free_slot()
            if s is None:
                break
            self._admit(self.queue.popleft(), s)
            n += 1
        if self.queue and n == 0 and self.n_active >= self.max_active:
            self._emit("backpressure", rid=self.queue[0].rid,
                       queued=len(self.queue), active=self.n_active)
        return n

    def _admit(self, req: _sched.Request, s: int) -> None:
        prompt = np.asarray(req.tokens, np.int64).reshape(-1)
        n_new = int(req.max_new_tokens if req.max_new_tokens is not None
                    else self.sc.max_new_tokens)
        batch = {"tokens": torch.from_numpy(prompt)[None].to(self.device)}
        for k, v in (req.extras or {}).items():
            batch[k] = torch.as_tensor(np.asarray(v))[None].to(self.device)
        reused = False
        if self.sc.share_prefix:
            key = _batch_bytes(prompt, req.extras)
            hit = self._prefill_cache.get(key)
            reused = hit is not None
            if reused:
                self.prefill_reuse += 1
            else:
                hit = self._prefill_cache[key] = self._prefill(batch)
            logits, cache1 = hit
        else:
            logits, cache1 = self._prefill(batch)
        gen = req.generator
        if gen is None and self.sc.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(0)
        self._gen[s] = gen
        tok0 = int(sample_tokens(logits, self.sc.temperature, gen)[0])
        if self._slot_live[s]:
            cache1, _ = inject_group(
                cache1, self.placements[s], self.fmap,
                voltage=self._slot_volt[s], method=self._slot_method[s])
        rows = _rows(self.state["cache"], self.batch_axes, s)
        for (_, dst), src in zip(pytree.flatten_with_path(rows),
                                 pytree.leaves(cache1)):
            dst.copy_(src)
        plen = int(prompt.shape[0])
        self._qpos_h[s] = prompt_positions(self.cfg, plen)
        self._slots[s] = req.rid
        self._admit_step[req.rid] = self.steps
        self._out[req.rid] = []
        self._remaining[req.rid] = n_new
        volt = self._slot_volt[s]
        self._meta[req.rid] = _sched.RequestResult(
            rid=req.rid, tokens=None, page_ids=np.zeros((0,), np.int32),
            placement=self.placements[s], voltage=volt,
            pages_shared=int(reused))
        self.admitted += 1
        self.peak_active = max(self.peak_active, self.n_active)
        self._emit("admission", rid=req.rid, plen=plen, n_new=n_new,
                   voltage=volt, prefill_reused=reused)
        # token 0 is the admission-time prefill sample (generate()'s tok0)
        self._collect(s, req.rid, tok0)

    def _prefill(self, batch):
        return self.bundle.module.prefill(self.params, batch, self.cfg,
                                          self.sc.max_len)

    def _retire(self, s: int) -> None:
        rid = self._slots[s]
        res = self._meta.pop(rid)
        res.tokens = np.asarray(self._out.pop(rid), np.int32)[None, :]
        self.results[rid] = res
        self._emit("retirement", rid=rid, tokens=int(res.tokens.shape[1]),
                   ttft_steps=res.ttft_steps)
        del self._remaining[rid]
        del self._admit_step[rid]
        self._slots[s] = None
        self._gen[s] = None
        self._qpos_h[s] = -1

    def run(self) -> Dict[Any, _sched.RequestResult]:
        """Drain the queue: admit / step / retire until every submitted
        request has finished.  Returns ``results``."""
        while self.queue or self.n_active:
            n = self.admit_pending()
            if self.n_active:
                self.step_once()
            elif n == 0:
                raise RuntimeError(f"stuck: {len(self.queue)} queued, none "
                                   "admitted, none active")
            # else: every admission retired at its prefill token
        return self.results

    @property
    def pricing_voltage(self) -> float:
        vs = [v for v, p in zip(self._slot_volt, self.placements)
              if p is not None and v is not None]
        return min(vs) if vs else V_NOM

    @property
    def pricing_voltages(self) -> List[float]:
        return [self.pricing_voltage]

    @property
    def stats(self) -> Dict[str, Any]:
        vs = [v for v, live in zip(self._slot_volt, self._slot_live)
              if live]
        out = {
            "route": "state",
            "cache_layouts": list(self.layout_kinds),
            "steps": self.steps,
            "admitted": self.admitted,
            "peak_active": self.peak_active,
            "voltage": min(vs) if vs else None,
            "n_shards": 1,
            "decode_traces": self._decode.traces,
            "prefill_reuse": self.prefill_reuse,
            "shards": [{
                "shard": 0,
                "active": self.n_active,
                "voltage": min(vs) if vs else None,
                "setpoint": None,
                "map_seed": (self.plan.map_seed
                             if self.plan is not None else None),
            }],
        }
        if self.expert_tiers is not None:
            out["expert_tiers"] = dict(
                collections.Counter(self.expert_tiers.values()))
        if self.metrics is not None:
            out["obs"] = self.metrics.snapshot(
                self.state, voltages=[self.pricing_voltage])
        if self.trace is not None:
            out["events"] = dict(self.trace.counts)
        return out
