"""Continuous-batching serving scheduler over the reliability-aware paged
KV cache (port of :mod:`repro.serving.scheduler`, single device).

Requests wait in a FIFO queue.  Admission takes a free serving slot plus
``max_len / page_slots`` pool pages matching the request's criticality
tier; :class:`~repro_torch.core.domains.CapacityError` from the pool is
backpressure -- the request waits for pages to be retired.  Prefill is
chunked into the serving step: each step consumes up to
``ServeConfig.prefill_chunk`` prompt tokens of every prefilling slot
while decoding slots advance one token through the paged kernel K4.
Prompt prefixes are shared copy-on-write: an admitted prompt maps the
longest cached page-aligned prefix read-only, a partly filled boundary
page is forked onto a private page before its first write, and pages
that may become shared are allocated under the strictest
(``shared_prefix``) tier.  Retirement releases page references; pages
whose holder sets empty return to the pool.

The reference runs one jitted, donated step.  The port's decode-only
step (no slot prefilling) is one CUDA graph over all ``num_slots`` rows
(:class:`~repro_torch.serving.captured.CapturedStep`), captured once per
scheduler (``stats['decode_traces'] == 1``) and replayed with its static
buffers -- tokens, positions (-1 for an idle slot), write floors -- loaded
from pinned host memory and the page table updated in place at admission,
fork and retirement; idle slots write nothing, by masks.  A step with a
prefilling slot runs ``prefill_chunk`` columns eagerly (its prefill
slots and ends are host tuples).  K4 launches once per layer and step
whatever the pool size, slot count, admissions and injection mode (the
write-path injection is plain PyTorch).  The row-wise
model stages and the prefill attention are row-invariant
(:mod:`repro_torch.models.layers`), so how a step is batched does not
change a request's bits.

Token-equivalence contract: every request's tokens equal those of
``generate(..., kv_placement=results[rid].placement)`` -- the request
alone on its own pages -- greedy and sampled (each request samples from
its own ``torch.Generator``), read and write injection modes, ECC on and
off, shared prefix or not.  Shared pages store clean K/V in every mode
and K4 applies the read-path masks in every mode: the stuck-at masks
and the ECC round are idempotent, so privately stored corrupt pages
re-mask to themselves while clean shared pages corrupt to exactly the
standalone stored values.  A clean pool (no undervolt plan) still runs
K4, with injection off; its tokens equal ``generate()`` with
``ServeConfig(kv_tile=page_slots)``, which routes clean decode through
K3 at the page tile.

Families without a pageable cache (no ``SUPPORTS_PAGED``) are dispatched
from ``__new__`` to :class:`repro_torch.serving.statearena.
StateArenaScheduler`, the same front door as the reference's.

Per-admission governor: with ``ServeConfig.governor`` each admission
re-plans the pool's voltage to the deepest one at which the whole
post-admission working set stays on usable PCs (a CapacityError is
backpressure); the voltage then applies to every running request.

Self-healing (``self_heal=SelfHealConfig()``, an ECC'd KV domain in read
mode): every step the telemetry scrub counts each referenced page's
SECDED events (K2's count-only entry), the host folds them into a per-row
:class:`~repro_torch.core.faultmap_posterior.FaultMapPosterior`, pages on
rows it accuses migrate inside the next step (a page copy and a
page-table rewrite before the decode read), their sources are
quarantined and drained arena blocks retire through an allocator that
adopted the pool's placement.  :meth:`ContinuousBatchingScheduler.
weaken_row` is the chaos hook.  The captured step never holds a
per-voltage tensor: it reads the scheduler's static threshold tables
(:meth:`~repro_torch.serving.paged.PagedKVCache.static_tables`), which a
voltage move or a chaos mark rewrites in place, and static migration
lanes and telemetry counters; ``decode_traces`` stays 1.

Not ported yet, each raising NotImplementedError that names its ROADMAP
slice: mesh sharding and per-shard setpoints, with the setpoint
escalation of self-healing under a governor (13).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pytree
from repro_torch.core.domains import CapacityError, DomainAllocator
from repro_torch.core.engine import resolve_method
from repro_torch.core.faultmap_posterior import FaultMapPosterior
from repro_torch.core.faultmodel import V_MIN, V_NOM
from repro_torch.models.base import ArchBundle, ArchConfig, cache_layouts
from repro_torch.obs.metrics import (MetricsRegistry, ObsConfig,
                                     init_step_counters, step_counter_delta)
from repro_torch.obs.trace import EventTrace
from repro_torch.serving.captured import CapturedStep
from repro_torch.serving.engine import ServeConfig, sample_tokens
from repro_torch.serving.paged import (PagedKVCache, PagePool,
                                       RequestPlacement, unported)
from repro_torch.training.governor import fleet_report


class ShardLayoutError(ValueError):
    """A shard layout the scheduler cannot serve (the reference's error
    for a serve mesh on the single-shard state-arena route)."""


@dataclasses.dataclass
class Request:
    """One serving request.  ``max_new_tokens`` defaults to the
    ServeConfig value; ``tier`` routes page allocation (a name from
    :data:`repro_torch.core.domains.TIERS` or a CriticalityTier);
    ``generator`` drives sampled decode (a fresh one seeded 0 on the
    scheduler's device if omitted, exactly like ``generate``)."""

    rid: Any
    tokens: Any                       # prompt token ids, shape (prompt_len,)
    max_new_tokens: Optional[int] = None
    tier: Any = "cheap"
    generator: Optional[torch.Generator] = None
    extras: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class RequestResult:
    rid: Any
    tokens: np.ndarray                # (1, max_new_tokens), like generate()
    page_ids: np.ndarray
    placement: Optional[RequestPlacement]
    voltage: Optional[float]          # KV-domain voltage at admission
    ttft_steps: Optional[int] = None  # steps from admission to token 0
    pages_shared: int = 0             # prefix pages mapped read-only
    shard: int = 0


@dataclasses.dataclass(frozen=True)
class SelfHealConfig:
    """Policy of the self-healing loop: ECC telemetry -> fault-map
    posterior -> in-step page migration -> block quarantine.

    Needs an ECC'd KV domain in ``kv_injection='read'`` mode: the SECDED
    counts are the telemetry, and read-mode pages store clean data, which
    makes a migrated page's payload equal what a replay on the final
    placement prefills.  ``max_migrations`` sizes the step's migration
    lanes; ``migrate_tier`` places targets, ``fallback_tier`` when it is
    exhausted.  ``setpoint_cap`` bounds the setpoint escalation of the
    sharded scheduler (ROADMAP slice 13)."""

    suspect_threshold: float = 0.9
    max_migrations: int = 4
    migrate_tier: Any = "shared_prefix"
    fallback_tier: Any = "cheap"
    setpoint_cap: float = 1.0


@dataclasses.dataclass
class _AdmitPlan:
    """Host-side page plan of one admission."""

    row: np.ndarray                   # (n_logical_pages,) page-table row
    retained: np.ndarray              # shared prefix pages mapped read-only
    eligible: bool                    # may register / extend the prefix cache
    matched: int                      # shared prefix length (tokens)
    fs: int                           # retained page count (full pages)
    cover: int                        # pages holding prompt rows
    fork_src: int                     # shared boundary page (scratch = none)
    fork_rows: int                    # clean rows to COW-copy
    cursor0: int                      # first prompt position to prefill
    wstart0: int                      # write floor (shared rows are r/o)


class ContinuousBatchingScheduler:
    """Serve overlapping requests through one mixed prefill/decode step.

    ``num_slots`` bounds concurrent requests; ``num_pages`` x
    ``page_slots`` sizes the KV pool; ``max_active`` optionally throttles
    admissions below ``num_slots``.  ``device`` holds the pool and runs
    the step (``params`` must live there).  ``capture=False`` runs the
    decode-only step of a CUDA device eagerly (the captured step's
    yardstick; the tokens are the same).  A family without
    ``SUPPORTS_PAGED`` gets a
    :class:`~repro_torch.serving.statearena.StateArenaScheduler`."""

    def __new__(cls, bundle: Optional[ArchBundle] = None, *args, **kwargs):
        if (cls is ContinuousBatchingScheduler and bundle is not None
                and not getattr(bundle.module, "SUPPORTS_PAGED", False)):
            from repro_torch.serving.statearena import StateArenaScheduler
            return object.__new__(StateArenaScheduler)
        return object.__new__(cls)

    def __init__(self, bundle: ArchBundle, cfg: ArchConfig, params,
                 sc: ServeConfig, *, num_slots: int, num_pages: int,
                 page_slots: int, max_active: Optional[int] = None,
                 device="cuda", mesh=None, shard_seeds=None,
                 shard_setpoints=None, self_heal=None,
                 obs: Optional[ObsConfig] = None, capture: bool = True):
        if (mesh is not None or shard_seeds is not None
                or shard_setpoints is not None):
            unported("mesh-sharded serving (mesh, shard_seeds, "
                      "shard_setpoints)", 13, "sharded-serving")
        if sc.kv_injection == "rewrite":
            raise ValueError(
                "kv_injection='rewrite' re-injects whole contiguous caches "
                "every token; the scheduler's caches are paged.  Use 'read' "
                "or 'write', or serve one-shot batches through generate() "
                "for the rewrite oracle")
        if sc.kv_injection not in ("auto", "read", "write"):
            raise ValueError(f"unknown kv_injection {sc.kv_injection!r}")
        self.bundle = bundle
        self.cfg = cfg
        self.params = params
        self.sc = sc
        self.device = resolve_device(device)
        self.num_slots = int(num_slots)
        self.max_active = int(num_slots if max_active is None
                              else max_active)
        if self.num_slots < 1 or not 1 <= self.max_active <= self.num_slots:
            raise ValueError(f"need 1 <= max_active ({self.max_active}) <= "
                             f"num_slots ({self.num_slots})")
        self.chunk = int(sc.prefill_chunk)
        if self.chunk < 1:
            raise ValueError(f"prefill_chunk={sc.prefill_chunk} must be >= 1")

        plan = (sc.undervolt if sc.undervolt is not None
                and sc.undervolt.enabled else None)
        self.pool = PagePool(bundle.module, cfg, max_len=sc.max_len,
                             page_slots=page_slots, num_pages=int(num_pages),
                             plan=plan)
        placed = self.pool.placement is not None
        self.governor = sc.governor
        if self.governor is not None:
            if sc.kv_voltage is not None:
                raise ValueError(
                    "ServeConfig.governor and kv_voltage are mutually "
                    "exclusive voltage controls")
            if sc.undervolt is None or self.governor.plan is not sc.undervolt:
                raise ValueError(
                    "sc.governor must be built from sc.undervolt (its "
                    "frontier and capacity tables belong to that plan's "
                    "fault map and domains)")
            if not placed:
                raise ValueError(
                    "ServeConfig.governor is set but the undervolt plan "
                    "does not place 'kv_cache' (or is disabled): admission "
                    "governance would silently be a no-op")
            if self.governor.config.domain != self.pool.domain.name:
                raise ValueError(
                    f"sc.governor governs domain "
                    f"{self.governor.config.domain!r} but the KV cache is "
                    f"placed in domain {self.pool.domain.name!r}")
        eff_v = sc.kv_voltage if sc.kv_voltage is not None else (
            self.pool.domain.voltage if placed else None)
        self.active = placed and (self.governor is not None
                                  or float(eff_v) < V_MIN - 1e-9)
        self.mode = "read" if sc.kv_injection == "auto" else sc.kv_injection
        self.voltage = float(eff_v) if eff_v is not None else 0.0
        method = sc.kv_method
        if self.active and method == "auto":
            if self.governor is not None:
                raise ValueError(
                    "kv_method='auto' cannot dispatch under an admission "
                    "governor (the KV voltage is re-planned per "
                    "admission); pass kv_method='word' or 'bitwise' "
                    "explicitly")
            method = ("word" if self.pool.domain.ecc else resolve_method(
                self.pool.faultmap, self.pool.placement, self.voltage))
        self.method = method if self.active else "word"
        self.kvc = PagedKVCache(self.pool, self.device)

        # ---- self-healing loop (telemetry -> posterior -> migration) ----
        self.heal = self_heal
        self._mig_slots = (self_heal.max_migrations
                           if self_heal is not None else 0)
        if self_heal is not None:
            if not placed or not self.pool.domain.ecc:
                raise ValueError(
                    "self_heal needs an ECC'd KV-cache placement: the "
                    "SECDED correction counts are the telemetry signal "
                    "(place kv_cache in a domain with ecc=True)")
            if self.mode != "read":
                raise ValueError(
                    f"self_heal needs kv_injection='read' (got "
                    f"{self.mode!r}): read-mode pages store clean data, "
                    "which is what makes an in-step page copy land the "
                    "exact payload a replay on the final placement "
                    "prefills")
            if self_heal.max_migrations < 1:
                raise ValueError(
                    f"self_heal.max_migrations={self_heal.max_migrations} "
                    "must be >= 1")
            self.posterior = FaultMapPosterior(self.pool.faultmap)
            # the suspect rows, as sorted pc * rows_per_pc + row keys
            self._suspect_keys = np.zeros((0,), np.int64)
            # retired arena blocks, as sorted pc * blocks_per_pc + block
            self._retired_keys = np.zeros((0,), np.int64)
            # long-lived ownership of the pool's arena blocks: placement
            # discards its allocators, so block retirement adopts the
            # placement into a fresh one guarded by the pool's live pages
            self.allocator = DomainAllocator(self.pool.faultmap.geometry,
                                             self.pool.domain,
                                             self.pool.faultmap)
            self.allocator.adopt(self.pool.placement)
            self.allocator.register_pool(self.pool)
        self.migrations = 0
        self.migration_stalls = 0
        self._pending_mig: List[Tuple[int, int]] = []
        tp = self.pool.total_pages
        self._chaos = np.zeros(tp, bool)
        self._telem_last = np.zeros((2, tp), np.int64)
        # (src, dst) migration lanes of the next step, scratch when idle
        self._mig_h = np.full((2, self._mig_slots), self.pool.scratch_id,
                              np.int64)
        # host seconds per step of the loop's host half (fold, plan and
        # finalize)
        self.heal_seconds: List[float] = []

        self.queue: collections.deque = collections.deque()
        self.results: Dict[Any, RequestResult] = {}
        s = self.num_slots
        self._slots: List[Optional[Any]] = [None] * s
        self._slot_priv: List[Optional[np.ndarray]] = [None] * s
        self._slot_shared: List[Optional[np.ndarray]] = [None] * s
        self._slot_plan: List[Optional[_AdmitPlan]] = [None] * s
        self._ptoks: List[Optional[np.ndarray]] = [None] * s
        self._gen: List[Optional[torch.Generator]] = [None] * s
        self._dec_h = [True] * s
        self._cursor_h = [0] * s
        self._plen_h = [0] * s
        self._qpos_h = [0] * s
        self._wstart_h = [0] * s
        self._tok_h = [0] * s
        self._admit_step: Dict[Any, int] = {}
        self._out: Dict[Any, List[int]] = {}
        self._remaining: Dict[Any, int] = {}
        self._meta: Dict[Any, RequestResult] = {}
        self.steps = 0
        self.admitted = 0
        self.peak_active = 0
        # host wall seconds of each step (device synchronised by the token
        # read), split by whether a slot was prefilling in it
        self.step_seconds: Dict[str, List[float]] = {"mixed": [],
                                                     "decode": []}

        self.obs = (obs if obs is not None
                    else sc.obs if sc.obs is not None else ObsConfig())
        self.layout_kinds = tuple(sorted(set(pytree.leaves(cache_layouts(
            bundle.module.cache_specs(cfg, 1, sc.max_len), sc.max_len)))))
        self.metrics: Optional[MetricsRegistry] = None
        self.trace: Optional[EventTrace] = None
        if self.obs.enabled:
            self.metrics = MetricsRegistry(1, self.pool, config=self.obs,
                                           layouts=self.layout_kinds)
            self.trace = EventTrace(capacity=self.obs.trace_capacity)
            self.pool.on_event = functools.partial(self._pool_event, 0)

        # Device state: the pool tree and the page tables.  Per-step lanes
        # (tokens, positions) are built on the host, which knows them, and
        # the decode-only step reads them from its static buffers.
        self.state = {
            "pool": self.kvc.init_pool(),
            "ptab": torch.full((s, self.pool.n_logical_pages),
                               self.pool.scratch_id, dtype=torch.int32,
                               device=self.device),
        }
        dev = self.device
        # the step's threshold tables: static buffers that a voltage move
        # or a chaos mark rewrites in place, so the captured step holds no
        # per-voltage tensor
        self._tables = self.kvc.static_tables(self.voltage)
        inputs = {
            "tok": torch.zeros((s, 1), dtype=torch.int64, device=dev),
            "pos": torch.full((s,), -1, dtype=torch.int32, device=dev),
            "wstart": torch.zeros((s,), dtype=torch.int32, device=dev)}
        if self.heal is not None:
            inputs["mig"] = torch.from_numpy(self._mig_h).to(dev)
            # per-page corrected / uncorrectable codewords, accumulated
            telem = torch.zeros((2, tp), dtype=torch.int32, device=dev)
            self._telem = telem
            self.state["telem"], self.state["telem_u"] = telem[0], telem[1]
        self._decode = CapturedStep(self._decode_body, dev, inputs=inputs,
                                    capture=capture)
        if self.obs.enabled:
            # counters live on the host, where the step is driven
            self.state["mtr"] = init_step_counters(1)

    # ---- host loop --------------------------------------------------------
    def submit(self, request: Request) -> None:
        n_new = (request.max_new_tokens
                 if request.max_new_tokens is not None
                 else self.sc.max_new_tokens)
        if int(n_new) < 1:
            raise ValueError(
                f"request {request.rid!r}: max_new_tokens={n_new} must be "
                ">= 1 (every admitted request samples at least the prefill "
                "token)")
        plen = int(np.asarray(request.tokens).reshape(-1).shape[0])
        if plen < 1:
            raise ValueError(f"request {request.rid!r}: empty prompt")
        if request.extras:
            raise ValueError(
                f"request {request.rid!r}: extras {sorted(request.extras)} "
                f"on the paged route; the {self.cfg.family!r} family is "
                "token-only")
        if plen > self.sc.max_len:
            raise ValueError(
                f"request {request.rid!r}: prompt length {plen} exceeds "
                f"max_len={self.sc.max_len}; chunked prefill writes the "
                "prompt through the paged ring in place and cannot rotate "
                "it (serve long prompts through generate())")
        self.queue.append(request)

    @property
    def n_active(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def _free_slot(self) -> Optional[int]:
        for g in range(self.num_slots):
            if self._slots[g] is None:
                return g
        return None

    def _plan_pages(self, req: Request, prompt: np.ndarray,
                    n_new: int) -> _AdmitPlan:
        """Match the prompt against the prefix cache, retain the shared
        pages and allocate the rest: pages that will hold prompt rows and
        be published at the transition under ``shared_prefix``, the rest
        under the request's tier.  Raises CapacityError with every side
        effect rolled back."""
        p = self.pool
        ps = p.page_slots
        plen = prompt.shape[0]
        holder = ("__req__", req.rid)
        # no sharing when generation would wrap the ring into read-only
        # prefix pages, or when a ring is a window (position-modular)
        eligible = (bool(self.sc.share_prefix) and p.uniform
                    and plen + n_new <= p.max_len)
        if eligible:
            matched, spids = p.match_prefix(prompt)
        else:
            matched, spids = 0, np.zeros((0,), np.int32)
        fs, r = matched // ps, matched % ps
        assert r == 0 or matched == plen
        cover = -(-plen // ps)
        retained = spids[:fs].astype(np.int32)
        if fs:
            p.retain(retained, holder)
        try:
            fork_dst = -1
            if r:
                fork_dst = p.cow_fork(int(spids[fs]), "shared_prefix")
            try:
                n_share = cover - fs - (1 if r else 0)
                share_new = (p.alloc(n_share, "shared_prefix")
                             if eligible and n_share else
                             np.zeros((0,), np.int32))
                try:
                    n_rest = (p.n_logical_pages - cover if eligible
                              else p.n_logical_pages)
                    rest = p.alloc(n_rest, req.tier)
                except CapacityError:
                    if len(share_new):
                        p.free(share_new)
                    raise
            except CapacityError:
                if fork_dst >= 0:
                    p.free([fork_dst])
                raise
        except CapacityError:
            if fs:
                p.release(retained, holder)
            raise
        fork = (np.array([fork_dst], np.int32) if r
                else np.zeros((0,), np.int32))
        row = np.concatenate([retained, fork, share_new, rest])
        assert row.shape[0] == p.n_logical_pages
        return _AdmitPlan(
            row=row, retained=retained, eligible=eligible, matched=matched,
            fs=fs, cover=(cover if eligible else 0),
            fork_src=(int(spids[fs]) if r else p.scratch_id), fork_rows=r,
            cursor0=(matched if matched < plen else plen - 1),
            wstart0=(matched if matched < plen else plen))

    def _rollback(self, plan: _AdmitPlan, rid) -> None:
        if plan.fs:
            self.pool.release(plan.retained, ("__req__", rid))
        self.pool.free(plan.row[plan.fs:])

    def _n_new(self, req: Request) -> int:
        return int(req.max_new_tokens if req.max_new_tokens is not None
                   else self.sc.max_new_tokens)

    def _govern(self, plan: _AdmitPlan, rid) -> bool:
        """The governor's half of an admission: the deepest voltage at
        which the whole post-admission working set (not just the new
        request's cache) stays on usable PCs.  On CapacityError the pages
        are rolled back and the admission is backpressure (False)."""
        need = (self.n_active + 1) * self.pool.request_words * 4
        try:
            v = float(self.governor.admit(need))
        except CapacityError:
            self._rollback(plan, rid)
            return False
        if v != self.voltage:
            self.voltage = v
            self._refresh_tables()
        return True

    def _refresh_tables(self) -> None:
        """Rewrite the step's static threshold tables, in place, at the
        current voltage with the chaos marks."""
        self.kvc.load_tables(self._tables, self.voltage,
                             self._chaos if self._chaos.any() else None)

    def admit_pending(self) -> int:
        """Admit queued requests FIFO until the slots, the page pool or
        the governor push back (evicting idle prefix-cache entries before
        giving up).  Returns the number admitted."""
        n = 0
        while self.queue and self.n_active < self.max_active:
            g = self._free_slot()
            req = self.queue[0]
            prompt = np.asarray(req.tokens, np.int32).reshape(-1)
            plan = None
            while plan is None:
                try:
                    plan = self._plan_pages(req, prompt, self._n_new(req))
                except CapacityError:
                    if not self.pool.evict_prefix():
                        break
            if plan is not None and self.governor is not None and (
                    not self._govern(plan, req.rid)):
                plan = None
            if plan is None:
                self._emit("backpressure", rid=req.rid,
                           queued=len(self.queue), active=self.n_active)
                break
            self.queue.popleft()
            self._admit(req, g, plan, prompt)
            n += 1
        return n

    def _admit(self, req: Request, g: int, plan: _AdmitPlan,
               prompt: np.ndarray) -> None:
        p = self.pool
        plen = prompt.shape[0]
        # scrub the freshly allocated pages (stale-tenant data) and COW-copy
        # the shared boundary page's clean prompt rows; retained shared
        # entries are passed as scratch (a reset there is harmless)
        reset_row = plan.row.copy()
        reset_row[:plan.fs] = p.scratch_id
        self.kvc.reset_and_fork(
            self.state["pool"], reset_row, plan.fork_src,
            int(plan.row[plan.fs]) if plan.fork_rows else p.scratch_id,
            plan.fork_rows, plan.fs * p.page_slots)
        self.state["ptab"][g] = torch.from_numpy(
            plan.row.astype(np.int32)).to(self.device)
        self._slots[g] = req.rid
        self._slot_shared[g] = plan.retained.copy()
        self._slot_priv[g] = plan.row[plan.fs:].copy()
        self._slot_plan[g] = plan
        self._ptoks[g] = prompt
        self._gen[g] = (req.generator if req.generator is not None else
                        torch.Generator(device=self.device).manual_seed(0))
        self._dec_h[g] = False
        self._cursor_h[g] = plan.cursor0
        self._plen_h[g] = plen
        self._qpos_h[g] = plen
        self._wstart_h[g] = plan.wstart0
        self._admit_step[req.rid] = self.steps
        self._out[req.rid] = []
        self._remaining[req.rid] = self._n_new(req)
        self._meta[req.rid] = RequestResult(
            rid=req.rid, tokens=None, page_ids=plan.row.copy(),
            placement=p.request_placement(plan.row),
            voltage=(self.voltage if p.placement is not None else None),
            pages_shared=plan.fs)
        self.admitted += 1
        self.peak_active = max(self.peak_active, self.n_active)
        self._emit("admission", shard=0, rid=req.rid, plen=int(plen),
                   n_new=self._remaining[req.rid],
                   pages_shared=int(plan.fs),
                   voltage=(self.voltage if p.placement is not None
                            else None))
        if plan.fork_rows:
            self._emit("cow_fork", shard=0, rid=req.rid,
                       src=int(plan.fork_src), dst=int(plan.row[plan.fs]),
                       rows=int(plan.fork_rows))

    def _transition(self, g: int) -> None:
        """Prefill finished this step: publish shareable pages, inject the
        request's pages (the standalone ``init_inject`` twin) and flip the
        slot to the decode phase."""
        rid = self._slots[g]
        plan = self._slot_plan[g]
        p = self.pool
        if plan.eligible:
            own = plan.row[plan.fs:plan.cover]
            if len(own):
                p.share(own, ("__req__", rid))
                self._slot_shared[g] = np.concatenate(
                    [self._slot_shared[g], own])
                self._slot_priv[g] = plan.row[plan.cover:].copy()
            prompt = self._ptoks[g]
            plen = prompt.shape[0]
            for ln in list(range(p.page_slots, plen, p.page_slots)) + [plen]:
                p.register_prefix(prompt[:ln],
                                  plan.row[:-(-ln // p.page_slots)])
        if self.active:
            # private pages take the mode's full treatment; pages that are
            # (or just became) shared keep their K/V clean in every mode and
            # only their pos bookkeeping takes write-path faults
            nsh = plan.cover if plan.eligible else 0
            pool = self.state["pool"]
            self.kvc.inject_pages(pool, self._slot_priv[g], self.voltage,
                                  method=self.method,
                                  skip_kv=(self.mode == "read"))
            self.kvc.inject_pages(pool, plan.row[:nsh], self.voltage,
                                  method=self.method, skip_kv=True)
        self._dec_h[g] = True

    def _collect(self, g: int, rid, token: int) -> None:
        out = self._out[rid]
        if not out:
            self._meta[rid].ttft_steps = self.steps - self._admit_step[rid]
        out.append(int(token))
        self._tok_h[g] = int(token)
        self._remaining[rid] -= 1
        if self._remaining[rid] == 0:
            self._retire(g)

    def _retire(self, g: int) -> None:
        rid = self._slots[g]
        res = self._meta.pop(rid)
        res.tokens = np.asarray(self._out.pop(rid), np.int32)[None, :]
        self.results[rid] = res
        self._emit("retirement", shard=0, rid=rid,
                   tokens=int(res.tokens.shape[1]),
                   ttft_steps=res.ttft_steps)
        if len(self._slot_shared[g]):
            self.pool.release(self._slot_shared[g], ("__req__", rid))
        if len(self._slot_priv[g]):
            self.pool.free(self._slot_priv[g])
        del self._remaining[rid]
        del self._admit_step[rid]
        self._slots[g] = None
        self._slot_priv[g] = None
        self._slot_shared[g] = None
        self._slot_plan[g] = None
        self._ptoks[g] = None
        self._gen[g] = None
        self._dec_h[g] = True
        self.state["ptab"][g] = self.pool.scratch_id

    def _decode_body(self):
        """The decode-only step over every serving slot, from the static
        buffers: the model step (idle slots at position -1 write to the
        scratch page), the masked write-path injection and, greedy, the
        argmax.  Returns the (S,) tokens, or the (S, V) logits when
        sampling."""
        inp = self._decode.inputs
        pool, ptab = self.state["pool"], self.state["ptab"]
        if self.heal is not None:
            self._migrate_in_step(inp["mig"])
        ctx = self.kvc.make_ctx(ptab, self._tables, method=self.method,
                                inject=self.active, wstart=inp["wstart"])
        logits, _ = self.bundle.module.decode_step(
            self.params, pool, {"tokens": inp["tok"]}, inp["pos"], self.cfg,
            fault_ctx=ctx)
        if self.active:
            self.kvc.post_step_inject(pool, ptab, inp["pos"], self._tables,
                                      mode=self.mode, method=self.method)
        if self.heal is not None:
            self._scrub()
        if self.sc.temperature <= 0.0:
            return sample_tokens(logits, 0.0)
        return logits

    def _migrate_in_step(self, mig) -> None:
        """The device half of this step's migrations, before the decode
        read: copy each staged page to its target, then rewrite every
        page-table entry naming a source, in place.  Idle lanes hold the
        scratch id, which the rewrite must not match (idle rows of the
        page table legitimately hold it)."""
        src, dst = mig[0], mig[1]
        ptab = self.state["ptab"]
        self.kvc.migrate_pages(self.state["pool"], src, dst)
        moving = src != self.pool.scratch_id
        eq = (ptab[:, :, None] == src[None, None, :]) & moving[None, None, :]
        repl = torch.where(eq, dst[None, None, :], 0).sum(-1)
        ptab.copy_(torch.where(eq.any(-1), repl.to(ptab.dtype), ptab))

    def _scrub(self) -> None:
        """The telemetry scrub after the write path: this step's per-page
        SECDED counts over every referenced page, added to the static
        counters."""
        corr, bad = self.kvc.scrub_telemetry(
            self.state["pool"], self.state["ptab"], self._tables)
        self._telem[0] += corr
        self._telem[1] += bad

    def _mixed_step(self, tok, pos, cols, wstart, pref, starts, ends, dec):
        """A step with prefilling slots, eager: the prompt chunks and the
        decoding slots' tokens in ``prefill_chunk`` columns.  Returns the
        (S, V) logits of each slot's sampled column."""
        dev = self.device
        pool, ptab = self.state["pool"], self.state["ptab"]
        if self.heal is not None:
            self._migrate_in_step(self._decode.inputs["mig"])
        ctx = self.kvc.make_ctx(
            ptab, self._tables, method=self.method, inject=self.active,
            wstart=torch.from_numpy(wstart).to(dev), prefill_slots=pref,
            prefill_start=starts, prefill_end=ends)
        logits, _ = self.bundle.module.decode_step(
            self.params, pool, {"tokens": torch.from_numpy(tok).to(dev)},
            torch.from_numpy(pos).to(dev), self.cfg, fault_ctx=ctx,
            logit_cols=torch.from_numpy(cols).to(dev))
        if self.active and dec:
            # write-path injection covers only decoding slots' writes;
            # prefill writes stay clean until the transition injection
            qpos = np.full(self.num_slots, -1, np.int32)
            qpos[dec] = [self._qpos_h[g] for g in dec]
            self.kvc.post_step_inject(pool, ptab,
                                      torch.from_numpy(qpos).to(dev),
                                      self._tables, mode=self.mode,
                                      method=self.method)
        if self.heal is not None:
            self._scrub()
        return logits

    def step_once(self) -> None:
        """One mixed step: every prefilling slot consumes a prompt chunk,
        every decoding slot one token; then transition finished prefills,
        collect tokens and retire finished requests.  Without a
        prefilling slot this is the captured decode-only step."""
        s = self.num_slots
        live = [g for g in range(s) if self._slots[g] is not None]
        pref = [g for g in live if not self._dec_h[g]]
        dec = [g for g in live if self._dec_h[g]]
        c = self.chunk if pref else 1
        tok = np.zeros((s, c), np.int64)
        pos = np.full((s, c), -1, np.int32)
        cols = np.zeros(s, np.int64)
        wstart = np.zeros(s, np.int32)
        starts, ends = [], []
        for g in dec:
            tok[g, 0] = self._tok_h[g]
            pos[g, 0] = self._qpos_h[g]
            wstart[g] = self._wstart_h[g]
        for g in pref:
            cur, plen = self._cursor_h[g], self._plen_h[g]
            t = self._ptoks[g][cur:cur + c]
            tok[g, :len(t)] = t
            pos[g, :len(t)] = cur + np.arange(len(t))
            cols[g] = min(max(plen - 1 - cur, 0), c - 1)
            wstart[g] = self._wstart_h[g]
            starts.append(cur)
            ends.append(min(cur + c, plen))
        heal_s, lanes = 0.0, {}
        if self.heal is not None:
            t0 = time.perf_counter()
            self._plan_self_heal()
            heal_s = time.perf_counter() - t0
            lanes["mig"] = self._mig_h
        if self.metrics is not None:
            act = torch.zeros(s, dtype=torch.bool)
            act[live] = True
            is_dec = torch.ones(s, dtype=torch.bool)
            is_dec[pref] = False
            delta = step_counter_delta(
                act=act, dec=is_dec,
                cursor=torch.tensor(self._cursor_h, dtype=torch.int32),
                plen=torch.tensor(self._plen_h, dtype=torch.int32),
                wstart=torch.tensor(self._wstart_h, dtype=torch.int32),
                chunk=self.chunk,
                n_logical_pages=self.pool.n_logical_pages,
                mig_src=torch.from_numpy(self._mig_h[0]),
                scratch_id=self.pool.scratch_id)
        t0 = time.perf_counter()
        greedy = self.sc.temperature <= 0.0
        with torch.no_grad():
            if pref:
                if lanes:
                    self._decode.load(**lanes)
                out = self._mixed_step(tok, pos, cols, wstart, pref,
                                       starts, ends, dec)
                if greedy:
                    out = sample_tokens(out, 0.0)
            else:
                self._decode.load(tok=tok, pos=pos[:, 0], wstart=wstart,
                                  **lanes)
                out = self._decode()
            sampling = dec + [g for g in pref
                              if self._plen_h[g] - self._cursor_h[g] <= c]
            toks = np.zeros(s, np.int64)
            if greedy:                       # out: the (S,) tokens
                toks = out.cpu().numpy()
            else:                            # out: the (S, V) logits
                picked = [sample_tokens(out[g:g + 1], self.sc.temperature,
                                        self._gen[g]) for g in sampling]
                if picked:
                    toks[sampling] = torch.cat(picked).cpu().numpy()
        seconds = time.perf_counter() - t0
        self.step_seconds["mixed" if pref else "decode"].append(seconds)
        if self.metrics is not None:
            self.metrics.record_step(seconds)
            self.state["mtr"][0] += delta
        self.steps += 1
        if self.heal is not None:
            # one D2H copy after the token read: no sync inside the step
            telem = self._telem.cpu().numpy().astype(np.int64)
            t0 = time.perf_counter()
            self._finalize_self_heal()
            self._fold_telemetry(telem)
            self.heal_seconds.append(heal_s + time.perf_counter() - t0)
        for g in dec:
            self._qpos_h[g] += 1
            self._collect(g, self._slots[g], toks[g])
        for g in pref:
            cur = self._cursor_h[g]
            fin = self._plen_h[g] - cur <= c
            self._cursor_h[g] = min(cur + c, self._plen_h[g])
            if fin:
                self._transition(g)
                self._collect(g, self._slots[g], toks[g])

    # ---- self-healing loop, host half ----------------------------------
    @property
    def suspects(self) -> set:
        """The suspect (pc, DRAM row) pairs of the posterior after the last
        step."""
        pcs, rows = np.divmod(self._suspect_keys,
                              self.pool.faultmap.rows_per_pc)
        return {(int(a), int(b)) for a, b in zip(pcs, rows)}

    @property
    def retired_blocks(self) -> set:
        """The (pc, arena block) pairs retired through the allocator."""
        pcs, blks = np.divmod(self._retired_keys,
                              self.allocator.blocks_per_pc)
        return {(int(a), int(b)) for a, b in zip(pcs, blks)}

    @property
    def telemetry(self) -> np.ndarray:
        """(2, total_pages) corrected / uncorrectable codewords counted per
        page up to the last step, as read on the host after it."""
        return self._telem_last
    def weaken_row(self, k: int, pc: int, row: int) -> np.ndarray:
        """Chaos hook: DRAM row ``row`` of pseudo-channel ``pc`` goes weak
        at runtime -- every pool page whose K/V payload overlaps it reads
        through weak-rate thresholds from the next step on (read path and
        scrub only; stored data stays clean, so replays stay exact).
        ``k`` is the shard (0: the port serves one).  Returns the affected
        page ids.  The step's tables are rewritten in place; the captured
        step is untouched."""
        if self.heal is None:
            raise ValueError(
                "weaken_row needs self_heal=SelfHealConfig(...): the chaos "
                "mask and telemetry lanes only exist under the self-healing "
                "loop")
        if int(k) != 0:
            raise ValueError(f"shard {k}: this scheduler serves one shard "
                             "(mesh sharding is ROADMAP slice 13)")
        pids = self.pool.pages_on_row(int(pc), int(row))
        if len(pids):
            self._chaos[pids] = True
            self._refresh_tables()
        return pids

    def _plan_self_heal(self) -> None:
        """Before the step: walk the suspect rows, quarantine free victim
        pages outright and stage up to ``max_migrations`` live-page
        migrations into the step's lanes (targets freshly allocated off
        suspect rows)."""
        if not self._suspect_keys.size or self._pending_mig:
            return
        heal, p = self.heal, self.pool
        pages = p.pages_on_rows(self._suspect_keys)
        _, first = np.unique(pages, return_index=True)
        suspect_pages = [int(q) for q in pages[np.sort(first)]]
        seen = set(suspect_pages)
        free_victims = [q for q in suspect_pages
                        if not p.is_owned(q) and not p.is_quarantined(q)]
        if free_victims:
            p.quarantine(free_victims)
        victims = [q for q in suspect_pages if p.is_owned(q)]
        pairs: List[Tuple[int, int]] = []
        rejects: List[int] = []
        for src in victims[:self._mig_slots]:
            dst = None
            while dst is None:
                try:
                    cand = int(p.alloc(1, heal.migrate_tier)[0])
                except CapacityError:
                    try:
                        cand = int(p.alloc(1, heal.fallback_tier)[0])
                    except CapacityError:
                        # keep serving on the suspect page, retry next step
                        self.migration_stalls += 1
                        break
                if cand in seen:
                    rejects.append(cand)        # the target is suspect too
                    continue
                dst = cand
            if dst is None:
                break
            pairs.append((src, dst))
        if rejects:
            p.quarantine(rejects)
        if not pairs:
            return
        for i, (src, dst) in enumerate(pairs):
            self._mig_h[:, i] = (src, dst)
        self._pending_mig = pairs

    def _finalize_self_heal(self) -> None:
        """After the step, which applied the staged migrations on the
        device: commit the host accounting (pool ownership and holders,
        every host page-id array, each live request's replay placement),
        then retire drained quarantined blocks through the adopted
        allocator."""
        p = self.pool
        pairs = self._pending_mig
        if pairs:
            for src, dst in pairs:
                p.migrate(src, dst)
                self._emit("migration", shard=0, src=int(src), dst=int(dst))
            self.migrations += len(pairs)

            def rewrite(arr):
                if arr is not None and len(arr):
                    for src, dst in pairs:
                        arr[arr == src] = dst

            for g, rid in enumerate(self._slots):
                if rid is None:
                    continue
                rewrite(self._slot_priv[g])
                rewrite(self._slot_shared[g])
                rewrite(self._slot_plan[g].row)
                rewrite(self._slot_plan[g].retained)
                # only live requests move: a retired request's placement
                # is its decode-time history
                meta = self._meta[rid]
                rewrite(meta.page_ids)
                meta.placement = p.request_placement(meta.page_ids)
            self._mig_h[:] = p.scratch_id
            self._pending_mig = []
        keys = p.retirable_block_keys()
        new = keys[~np.isin(keys, self._retired_keys)]
        if new.size:
            self.allocator.quarantine(p.block_segments(new))
            self._retired_keys = np.union1d(self._retired_keys, new)
            for pc, blk in zip(*np.divmod(new,
                                          self.allocator.blocks_per_pc)):
                self._emit("block_retire", shard=0, pc=int(pc),
                           block=int(blk))

    def _fold_telemetry(self, telem: np.ndarray) -> None:
        """Diff the telemetry counters read after the step and fold each
        changed page's counts into the posterior, over the page's rows
        (pages ascending, each page's rows sorted, as the reference folds
        them); refresh the suspect set and re-plan an adaptive governor
        when it moves."""
        d = telem - self._telem_last
        self._telem_last = telem
        hits = np.flatnonzero((d[0] > 0) | (d[1] > 0))
        if len(hits):
            keys, counts = self.pool.page_row_keys(hits)
            pcs, rows = np.divmod(keys, self.pool.faultmap.rows_per_pc)
            self.posterior.observe_many(
                pcs, rows, np.repeat(d[0, hits], counts),
                np.repeat(d[1, hits], counts), self.pool.page_codewords(),
                self.voltage)
        new = self.posterior.suspect_keys(self.voltage,
                                          self.heal.suspect_threshold)
        if not np.array_equal(new, self._suspect_keys):
            self._suspect_keys = new
            if (self.governor is not None
                    and self.governor.config.mode == "adaptive"):
                self.governor.replan(self.posterior)
                self._emit("replan", shard=0, suspect_rows=len(new))

    def run(self) -> Dict[Any, RequestResult]:
        """Drain the queue: admit / step / retire until every submitted
        request has finished.  Returns ``results``."""
        while self.queue or self.n_active:
            self.admit_pending()
            if not self.n_active:
                if not self.queue:
                    break
                # nothing running and the head request still cannot be
                # admitted: it can never fit -- let the pool raise
                req = self.queue[0]
                prompt = np.asarray(req.tokens, np.int32).reshape(-1)
                plan = self._plan_pages(req, prompt, self._n_new(req))
                self._rollback(plan, req.rid)
                if self.governor is not None:
                    self.governor.admit(self.pool.request_words * 4)
                raise CapacityError(
                    "scheduler", self.pool.request_words * 4,
                    self.pool.free_pages * self.pool.page_set_words * 4,
                    "admission stuck with an idle pool")
            self.step_once()
        return self.results

    # ---- observability hooks ----------------------------------------------
    def _emit(self, kind: str, **kw) -> None:
        if self.trace is not None:
            kw.setdefault("layout", "+".join(self.layout_kinds))
            self.trace.emit(kind, step=self.steps, **kw)

    def _pool_event(self, shard: int, kind: str, **data) -> None:
        self._emit(kind, shard=shard, **data)

    @property
    def pricing_voltage(self) -> float:
        """The rail the energy accountant prices HBM traffic at."""
        return self.voltage if self.pool.placement is not None else V_NOM

    @property
    def pricing_voltages(self) -> List[float]:
        """Per shard (one here): :attr:`pricing_voltage`, the reference's
        exporter interface."""
        return [self.pricing_voltage]

    @property
    def stats(self) -> Dict[str, Any]:
        p = self.pool
        out = {
            "route": "paged",
            "cache_layouts": list(self.layout_kinds),
            "steps": self.steps,
            "admitted": self.admitted,
            "peak_active": self.peak_active,
            "free_pages": p.free_pages,
            "weak_pages": p.num_weak_pages,
            "voltage": self.voltage,
            "prefill_chunk": self.chunk,
            "shared_pages": p.shared_pages,
            "prefix_entries": p.prefix_entries,
            "n_shards": 1,
            "decode_traces": self._decode.traces,
        }
        plan = self.sc.undervolt
        shard = {"shard": 0, "active": self.n_active,
                 "free_pages": p.free_pages, "weak_pages": p.num_weak_pages,
                 "shared_pages": p.shared_pages, "voltage": self.voltage,
                 "setpoint": None,
                 "map_seed": (int(plan.map_seed) if plan is not None
                              and plan.enabled else None)}
        if self.heal is not None:
            post = self.posterior.stats()
            shard.update(
                corrected=post["corrected"],
                uncorrectable=post["uncorrectable"],
                tracked_rows=post["tracked_rows"],
                suspect_rows=int(self._suspect_keys.size),
                migrations=self.migrations,
                migration_stalls=self.migration_stalls,
                quarantined_pages=len(p.quarantined_pages),
                quarantined_blocks=len(self.allocator.quarantined_blocks),
                setpoint_escalations=0,
                governor_replans=(self.governor.replans
                                  if self.governor is not None else 0))
            for key in ("corrected", "uncorrectable", "migrations",
                        "quarantined_pages", "quarantined_blocks",
                        "setpoint_escalations"):
                out[key] = shard[key]
        out["shards"] = [shard]
        if self.governor is not None:
            out["fleet"] = fleet_report([self.governor], [self.voltage],
                                        [None])
        if self.metrics is not None:
            out["obs"] = self.metrics.snapshot(
                self.state, voltages=[self.pricing_voltage])
        if self.trace is not None:
            out["events"] = dict(self.trace.counts)
        return out
