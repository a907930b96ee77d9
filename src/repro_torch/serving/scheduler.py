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

The reference runs one jitted, donated step; the port's step is one
eager Python function over persistent tensors, updated in place.  Its
launch budget is the counterpart of the reference's one trace: K4
launches once per layer and step whatever the pool size, slot count,
admissions and injection mode (the write-path injection is plain
PyTorch).  A decode-only step runs one token column per slot; a step
with a prefilling slot runs ``prefill_chunk`` columns.  The row-wise
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

Not ported yet, each raising NotImplementedError that names its ROADMAP
slice: the admission governor (6), self-healing (9), families without a
pageable cache (the state arena, 12) and mesh sharding (13).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pytree
from repro_torch.core.domains import CapacityError
from repro_torch.core.engine import resolve_method
from repro_torch.core.faultmodel import V_MIN, V_NOM
from repro_torch.models.base import ArchBundle, ArchConfig, cache_layouts
from repro_torch.obs.metrics import (MetricsRegistry, ObsConfig,
                                     init_step_counters, step_counter_delta)
from repro_torch.obs.trace import EventTrace
from repro_torch.serving.engine import ServeConfig, sample_tokens
from repro_torch.serving.paged import (PagedKVCache, PagePool,
                                       RequestPlacement, unported)


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
    the step (``params`` must live there)."""

    def __init__(self, bundle: ArchBundle, cfg: ArchConfig, params,
                 sc: ServeConfig, *, num_slots: int, num_pages: int,
                 page_slots: int, max_active: Optional[int] = None,
                 device="cuda", mesh=None, shard_seeds=None,
                 shard_setpoints=None, self_heal=None,
                 obs: Optional[ObsConfig] = None):
        if not getattr(bundle.module, "SUPPORTS_PAGED", False):
            unported(f"serving the {cfg.family!r} family (no pageable "
                      "cache: the state-arena scheduler)", 12, "model-zoo")
        if (mesh is not None or shard_seeds is not None
                or shard_setpoints is not None):
            unported("mesh-sharded serving (mesh, shard_seeds, "
                      "shard_setpoints)", 13, "sharded-serving")
        if self_heal is not None:
            unported("self-healing serving (self_heal)", 9, "self-healing")
        if sc.governor is not None:
            unported("ServeConfig.governor (admission governor)", 6,
                      "frontier/governor")
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
        eff_v = sc.kv_voltage if sc.kv_voltage is not None else (
            self.pool.domain.voltage if placed else None)
        self.active = placed and float(eff_v) < V_MIN - 1e-9
        self.mode = "read" if sc.kv_injection == "auto" else sc.kv_injection
        self.voltage = float(eff_v) if eff_v is not None else 0.0
        method = sc.kv_method
        if self.active and method == "auto":
            method = ("word" if self.pool.domain.ecc else resolve_method(
                self.pool.faultmap, self.pool.placement, self.voltage))
        self.method = method if self.active else "word"
        self.kvc = PagedKVCache(self.pool, self.device)

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
        # (tokens, positions) are built on the host, which knows them.
        self.state = {
            "pool": self.kvc.init_pool(),
            "ptab": torch.full((s, self.pool.n_logical_pages),
                               self.pool.scratch_id, dtype=torch.int32,
                               device=self.device),
        }
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

    def admit_pending(self) -> int:
        """Admit queued requests FIFO until the slots or the page pool push
        back (evicting idle prefix-cache entries before giving up).
        Returns the number admitted."""
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

    def step_once(self) -> None:
        """One mixed step: every prefilling slot consumes a prompt chunk,
        every decoding slot one token; then transition finished prefills,
        collect tokens and retire finished requests."""
        s = self.num_slots
        live = [g for g in range(s) if self._slots[g] is not None]
        pref = [g for g in live if not self._dec_h[g]]
        dec = [g for g in live if self._dec_h[g]]
        c = self.chunk if pref else 1
        tok = np.zeros((s, c), np.int64)
        pos = np.full((s, c), -1, np.int32)
        cols = np.zeros(s, np.int64)
        wstart = np.zeros(s, np.int32)
        ends = []
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
            ends.append(min(cur + c, plen))
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
                mig_src=torch.zeros(0, dtype=torch.int32),
                scratch_id=self.pool.scratch_id)
        t0 = time.perf_counter()
        dev = self.device
        pool, ptab = self.state["pool"], self.state["ptab"]
        ctx = self.kvc.make_ctx(
            ptab, self.voltage, method=self.method, inject=self.active,
            wstart=torch.from_numpy(wstart).to(dev), prefill_slots=pref,
            prefill_end=ends)
        with torch.no_grad():
            logits, _ = self.bundle.module.decode_step(
                self.params, pool, {"tokens": torch.from_numpy(tok).to(dev)},
                torch.from_numpy(pos).to(dev), self.cfg, fault_ctx=ctx,
                logit_cols=torch.from_numpy(cols).to(dev))
            if self.active and dec:
                # write-path injection covers only decoding slots' writes;
                # prefill writes stay clean until the transition injection
                rows = torch.tensor(dec, device=dev)
                self.kvc.post_step_inject(
                    pool, ptab[rows],
                    torch.tensor([self._qpos_h[g] for g in dec],
                                 device=dev),
                    self.voltage, mode=self.mode, method=self.method)
            sampling = dec + [g for g in pref
                              if self._plen_h[g] - self._cursor_h[g] <= c]
            toks = np.zeros(s, np.int64)
            if self.sc.temperature <= 0.0:
                toks = sample_tokens(logits, 0.0).cpu().numpy()
            else:
                picked = [sample_tokens(logits[g:g + 1], self.sc.temperature,
                                        self._gen[g]) for g in sampling]
                if picked:
                    toks[sampling] = torch.cat(picked).cpu().numpy()
        seconds = time.perf_counter() - t0
        self.step_seconds["mixed" if pref else "decode"].append(seconds)
        if self.metrics is not None:
            self.metrics.record_step(seconds)
            self.state["mtr"][0] += delta
        self.steps += 1
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
        }
        if self.metrics is not None:
            out["obs"] = self.metrics.snapshot(
                self.state, voltages=[self.pricing_voltage])
        if self.trace is not None:
            out["events"] = dict(self.trace.counts)
        return out
