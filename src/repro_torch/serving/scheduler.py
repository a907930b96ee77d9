"""Continuous-batching serving scheduler over the reliability-aware paged
KV cache, optionally sharded over a serving mesh (port of
:mod:`repro.serving.scheduler`).

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
slots and ends are host tuples).  K4 launches once per shard, layer and
step whatever the pool size, slot count, admissions and injection mode
(the write-path injection is plain PyTorch).  The row-wise
model stages and the prefill attention are row-invariant
(:mod:`repro_torch.models.layers`), so how a step is batched does not
change a request's bits.

Mesh sharding (``mesh=make_serve_mesh(n)``, :mod:`repro_torch.launch.
mesh`): slots and pages are global totals split evenly over ``n``
shards; global slot ``g = shard * slots_per_shard + slot``.  Each shard
owns its own page pool and arena blocks, its own independently seeded
fault map (``shard_seeds``, by default :func:`repro_torch.core.hbm.
fleet_map_seeds` of the plan's seed, so shard 0 reproduces the
single-device map), its own governor, setpoint (``shard_setpoints``) and
voltage, its own threshold tables and its own self-healing state.
Admission routes to the shard with the most free pages (ties to the
lowest index).  Without a process group the shards are logical shards on
the scheduler's one device: the step runs the reference's mesh-less
all-shard step, one shard's step after another inside the one captured
graph, so K4 runs once per shard and layer with that shard's pool, seed
and tables.

Over ranks (``make_serve_mesh(n, group=...)``, one process per rank) the
control plane is replicated: every rank runs the whole fleet's host loop
-- admission, routing, every shard's page bookkeeping, governor,
setpoint, escalation and self-healing -- and so decides the same thing
with no protocol of its own.  A rank holds only its own shards' device
state (pool, static tables, captured step) and runs only their device
work; after each step the ranks exchange, in one ``all_gather_object``
over the gloo control group, what the host loop reads back from the
device (each shard's sampled tokens and, under self-healing, its
telemetry counts), so every rank's host state stays identical and every
rank holds every result.  ``exchange_seconds`` times the exchange.

Token-equivalence contract: every request's tokens equal those of
``generate(..., kv_placement=results[rid].placement)`` -- the request
alone on its own pages, against its shard's plan
(:meth:`ContinuousBatchingScheduler.shard_plan`) -- greedy and sampled
(each request samples from its own ``torch.Generator``), read and write
injection modes, ECC on and off, shared prefix or not, at every shard
count.  Shared pages store clean K/V in every mode
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
re-plans its shard's voltage to the deepest one at which the shard's
whole post-admission working set stays on usable PCs, capped by the
shard's setpoint; the voltage then applies to every request running on
the shard.  A CapacityError is backpressure, unless self-healing can
relax the shard's rate setpoint one decade (:meth:`_escalate_setpoint`,
the ``escalation`` event) and the retry admits.

Self-healing (``self_heal=SelfHealConfig()``, an ECC'd KV domain in read
mode): every step the telemetry scrub counts each referenced page's
SECDED events (K2's count-only entry), the host folds them into each
shard's per-row :class:`~repro_torch.core.faultmap_posterior.
FaultMapPosterior`, pages on rows it accuses migrate inside the next step
(a page copy and a page-table rewrite before the decode read), their
sources are quarantined and drained arena blocks retire through an
allocator that adopted the shard pool's placement.
:meth:`ContinuousBatchingScheduler.weaken_row` is the chaos hook.  The
captured step never holds a per-voltage tensor: it reads each shard's
static threshold tables (:meth:`~repro_torch.serving.paged.PagedKVCache.
static_tables`), which a voltage move or a chaos mark rewrites in place,
and static migration lanes and telemetry counters; ``decode_traces``
stays 1.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import pytree
from repro_torch.core.domains import CapacityError, DomainAllocator
from repro_torch.core.engine import resolve_method
from repro_torch.core.faultmap_posterior import FaultMapPosterior
from repro_torch.core.faultmodel import V_MIN, V_NOM
from repro_torch.core.hbm import fleet_map_seeds
from repro_torch.launch.mesh import ShardLayoutError
from repro_torch.models.base import ArchBundle, ArchConfig, cache_layouts
from repro_torch.obs.metrics import (MetricsRegistry, ObsConfig,
                                     init_step_counters, step_counter_delta)
from repro_torch.obs.trace import EventTrace
from repro_torch.serving.captured import CapturedStep
from repro_torch.serving.engine import ServeConfig, sample_tokens
from repro_torch.serving.paged import (PagedKVCache, PagePool,
                                       RequestPlacement)
from repro_torch.training.governor import VoltageGovernor, fleet_report


def validate_shard_layout(n_shards: int, num_slots: int, num_pages: int,
                          *, base_seed: int = 0,
                          seeds: Optional[Sequence[int]] = None,
                          setpoints: Optional[Sequence[float]] = None,
                          ) -> Tuple[Tuple[int, ...],
                                     Tuple[Optional[float], ...]]:
    """Check a serve-mesh layout and resolve per-shard seeds/setpoints.

    Slots and pages must split evenly so every shard runs the same
    shapes, and per-shard fault-map seeds must be distinct -- two shards
    sharing a seed would silently model one physical HBM part twice."""
    if n_shards < 1:
        raise ShardLayoutError(f"n_shards={n_shards} must be >= 1")
    if num_slots % n_shards:
        raise ShardLayoutError(
            f"ServeConfig capacity num_slots={num_slots} is not "
            f"divisible by the shard count {n_shards}: every shard owns "
            "an equal fixed-capacity slot range (pick num_slots = "
            f"{n_shards} * slots_per_shard)")
    if num_pages % n_shards:
        raise ShardLayoutError(
            f"num_pages={num_pages} is not divisible by the shard "
            f"count {n_shards}: the page pool is partitioned into "
            "equal per-shard arenas (pick num_pages = "
            f"{n_shards} * pages_per_shard)")
    if seeds is None:
        seeds = fleet_map_seeds(base_seed, n_shards)
    seeds = tuple(int(s) for s in seeds)
    if len(seeds) != n_shards:
        raise ShardLayoutError(
            f"shard_seeds has {len(seeds)} entries for {n_shards} "
            "shards: pass exactly one fault-map seed per shard")
    dup = [s for s, c in collections.Counter(seeds).items() if c > 1]
    if dup:
        raise ShardLayoutError(
            f"per-shard fault-map seed collision: seed(s) {sorted(dup)} "
            "appear on more than one shard; every shard models an "
            "independent physical HBM part and must draw its own map "
            "(use core.hbm.fleet_map_seeds or pass distinct seeds)")
    if setpoints is None:
        sp: Tuple[Optional[float], ...] = (None,) * n_shards
    else:
        if len(setpoints) != n_shards:
            raise ShardLayoutError(
                f"shard_setpoints has {len(setpoints)} entries for "
                f"{n_shards} shards: pass one governor setpoint per "
                "shard (or None)")
        sp = tuple(None if s is None else float(s) for s in setpoints)
    return seeds, sp


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
    shard: int = 0                    # mesh shard that served the request


@dataclasses.dataclass(frozen=True)
class SelfHealConfig:
    """Policy of the self-healing loop: ECC telemetry -> fault-map
    posterior -> in-step page migration -> block quarantine.

    Needs an ECC'd KV domain in ``kv_injection='read'`` mode: the SECDED
    counts are the telemetry, and read-mode pages store clean data, which
    makes a migrated page's payload equal what a replay on the final
    placement prefills.  ``max_migrations`` sizes each shard's migration
    lanes; ``migrate_tier`` places targets, ``fallback_tier`` when it is
    exhausted.  ``setpoint_cap`` bounds the graceful-degradation
    escalation: when admission fails under quarantine pressure, the
    shard's rate setpoint is raised x10 (up to the cap) and the
    admission retried."""

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


@dataclasses.dataclass
class _Shard:
    """One shard's runtime: its page pool (its fault map drawn from the
    shard's seed) and the pool's device tree, the paged-cache helper and
    the static threshold tables the step reads, the voltage governor,
    setpoint and voltage, the injection method resolved against the
    shard's map, and its self-healing state."""

    index: int
    seed: Optional[int]
    plan: Any
    pool: PagePool
    kvc: PagedKVCache
    governor: Any
    setpoint: Optional[float]
    method: str
    voltage: float
    local: bool = True                # this process runs its device work
    tree: Any = None                  # the pool's device tree
    tables: Any = None                # static PoolTables of the step
    chaos: Any = None                 # (total_pages,) bool, weakened pages
    # Self-healing (unset without SelfHealConfig):
    posterior: Any = None
    allocator: Any = None             # adopted DomainAllocator (quarantine)
    # the suspect rows, as sorted pc * rows_per_pc + row keys
    suspect_keys: Any = None
    # retired arena blocks, as sorted pc * blocks_per_pc + block keys
    retired_keys: Any = None
    pending_mig: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    migrations: int = 0
    migration_stalls: int = 0
    setpoint_escalations: int = 0

    @property
    def suspects(self) -> set:
        """The suspect (pc, DRAM row) pairs after the last step."""
        pcs, rows = np.divmod(self.suspect_keys,
                              self.pool.faultmap.rows_per_pc)
        return {(int(a), int(b)) for a, b in zip(pcs, rows)}

    @property
    def retired_blocks(self) -> set:
        """The (pc, arena block) pairs retired through the allocator."""
        pcs, blks = np.divmod(self.retired_keys,
                              self.allocator.blocks_per_pc)
        return {(int(a), int(b)) for a, b in zip(pcs, blks)}


class ContinuousBatchingScheduler:
    """Serve overlapping requests through one mixed prefill/decode step.

    ``num_slots`` bounds concurrent requests; ``num_pages`` x
    ``page_slots`` sizes the KV pool; ``max_active`` optionally throttles
    admissions below ``num_slots``.  ``device`` holds the pools and runs
    the step (``params`` must live there).  ``capture=False`` runs the
    decode-only step of a CUDA device eagerly (the captured step's
    yardstick; the tokens are the same).

    With ``mesh`` (a 1-D serving mesh from :func:`repro_torch.launch.
    mesh.make_serve_mesh`, every shard on ``device``), slots and pages
    are global totals split evenly across the shards; each shard draws
    its own fault map from ``shard_seeds`` and, under a governor, admits
    against its own ``shard_setpoints`` entry.  A family without
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
                 device="cuda", mesh=None, mesh_axis: str = "serve",
                 shard_seeds: Optional[Sequence[int]] = None,
                 shard_setpoints: Optional[Sequence[float]] = None,
                 self_heal: Optional[SelfHealConfig] = None,
                 obs: Optional[ObsConfig] = None, capture: bool = True):
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
        self.mesh = mesh
        if mesh is not None:
            if mesh_axis not in mesh.axis_names:
                raise ShardLayoutError(
                    f"mesh axis {mesh_axis!r} missing from mesh axes "
                    f"{tuple(mesh.axis_names)}: build the serving mesh "
                    "with launch.mesh.make_serve_mesh (1-D, axis "
                    "'serve') or pass mesh_axis=<your axis>")
            other = [a for a in mesh.axis_names
                     if a != mesh_axis and mesh.shape[a] > 1]
            if other:
                raise ShardLayoutError(
                    f"serve mesh must be 1-D: axes {other} have size > "
                    "1 besides the serve axis (model-parallel axes are "
                    "not supported by the sharded scheduler)")
            self.rank_group = getattr(mesh, "group", None)
            if self.rank_group is None:
                owners = (0,) * len(mesh.devices)
            else:
                owners = mesh.owners
            mine = [k for k, o in enumerate(owners)
                    if o == (0 if self.rank_group is None
                             else self.rank_group.rank)]
            away = sorted({str(mesh.devices[k]) for k in mine
                           if resolve_device(mesh.devices[k]) != self.device})
            if away:
                raise ShardLayoutError(
                    f"mesh shards on {away}, not on the scheduler's device "
                    f"{self.device}, and no process group spans them: "
                    "without a group the port serves a mesh's shards as "
                    "logical shards on one device (make_serve_mesh(n, "
                    "devices=[device] * n)); over devices, one rank a "
                    "device (make_serve_mesh(n, group=...))")
            self.n_shards = int(mesh.shape[mesh_axis])
            self._owners = tuple(owners)
        else:
            if shard_seeds is not None or shard_setpoints is not None:
                raise ShardLayoutError(
                    "shard_seeds/shard_setpoints require a serve mesh "
                    "(pass mesh=make_serve_mesh(n))")
            self.n_shards = 1
            self.rank_group = None
            self._owners = (0,)
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
        seeds, setpoints = validate_shard_layout(
            self.n_shards, self.num_slots, int(num_pages),
            base_seed=plan.map_seed if plan is not None else 0,
            seeds=shard_seeds, setpoints=shard_setpoints)
        self.shard_seeds = seeds
        self.slots_per_shard = self.num_slots // self.n_shards
        self.pages_per_shard = int(num_pages) // self.n_shards

        # ---- voltage control / injection mode (mirrors generate()) ----
        # Shard 0 carries the base plan; the global checks run against
        # its pool, then each shard resolves what depends on its own map.
        pool0 = PagePool(bundle.module, cfg, max_len=sc.max_len,
                         page_slots=page_slots,
                         num_pages=self.pages_per_shard, plan=plan,
                         shard=(0 if mesh is not None else None))
        placed = pool0.placement is not None
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
            if self.governor.config.domain != pool0.domain.name:
                raise ValueError(
                    f"sc.governor governs domain "
                    f"{self.governor.config.domain!r} but the KV cache is "
                    f"placed in domain {pool0.domain.name!r}")
        if any(sp is not None for sp in setpoints) and self.governor is None:
            raise ShardLayoutError(
                "shard_setpoints need an admission governor "
                "(ServeConfig.governor): setpoints are per-shard "
                "governor walk targets")
        eff_v = sc.kv_voltage if sc.kv_voltage is not None else (
            pool0.domain.voltage if placed else None)
        self.active = placed and (self.governor is not None
                                  or float(eff_v) < V_MIN - 1e-9)
        self.mode = "read" if sc.kv_injection == "auto" else sc.kv_injection
        volt0 = float(eff_v) if eff_v is not None else 0.0
        if (self.active and sc.kv_method == "auto"
                and self.governor is not None):
            raise ValueError(
                "kv_method='auto' cannot dispatch under an admission "
                "governor (the KV voltage is re-planned per admission); "
                "pass kv_method='word' or 'bitwise' explicitly")

        # ---- per-shard pools, fault maps, governors ---------------------
        self._shards: List[_Shard] = []
        for k, seed in enumerate(seeds):
            if plan is None or seed == int(plan.map_seed):
                plan_k = plan
            else:
                plan_k = dataclasses.replace(plan, map_seed=seed)
            pool_k = pool0 if (k == 0 and plan_k is plan) else PagePool(
                bundle.module, cfg, max_len=sc.max_len,
                page_slots=page_slots, num_pages=self.pages_per_shard,
                plan=plan_k, shard=(k if mesh is not None else None))
            gov_k = None
            if self.governor is not None:
                gov_k = (self.governor if plan_k is plan else
                         VoltageGovernor(plan_k, self.governor.config))
            method_k = sc.kv_method
            if self.active and method_k == "auto":
                method_k = ("word" if pool_k.domain.ecc else resolve_method(
                    pool_k.faultmap, pool_k.placement, volt0))
            kvc = PagedKVCache(pool_k, self.device)
            local = self._owners[k] == self.rank
            self._shards.append(_Shard(
                index=k, seed=(seed if plan is not None else None),
                plan=plan_k, pool=pool_k, kvc=kvc, governor=gov_k,
                setpoint=setpoints[k],
                method=method_k if self.active else "word", voltage=volt0,
                local=local,
                # another rank's shard: host state only
                tree=kvc.init_pool() if local else None,
                # the step's threshold tables: static buffers that a
                # voltage move or a chaos mark rewrites in place, so the
                # captured step holds no per-voltage tensor
                tables=kvc.static_tables(volt0) if local else None,
                chaos=np.zeros(pool_k.total_pages, bool)))
        self._local_shards = [sh for sh in self._shards if sh.local]
        # the global slots of each rank's shards, in shard order
        self._rank_rows = {r: np.concatenate([
            np.arange(k * self.slots_per_shard, (k + 1) * self.slots_per_shard)
            for k in range(self.n_shards) if self._owners[k] == r])
            for r in sorted(set(self._owners))}
        self._local_rows = self._rank_rows[self.rank]
        self._row_pos = {int(g): i for i, g in enumerate(self._local_rows)}
        self.pool = self._shards[0].pool       # single-shard views
        self.kvc = self._shards[0].kvc
        self.method = self._shards[0].method

        # ---- self-healing loop (telemetry -> posterior -> migration) ----
        self.heal = self_heal
        self._mig_slots = (self_heal.max_migrations
                           if self_heal is not None else 0)
        if self_heal is not None:
            if not placed or not pool0.domain.ecc:
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
            for sh in self._shards:
                sh.posterior = FaultMapPosterior(sh.pool.faultmap)
                sh.suspect_keys = np.zeros((0,), np.int64)
                sh.retired_keys = np.zeros((0,), np.int64)
                # long-lived ownership of the pool's arena blocks:
                # placement discards its allocators, so block retirement
                # adopts the placement into a fresh one guarded by the
                # pool's live pages
                sh.allocator = DomainAllocator(sh.pool.faultmap.geometry,
                                               sh.pool.domain,
                                               sh.pool.faultmap)
                sh.allocator.adopt(sh.pool.placement)
                sh.allocator.register_pool(sh.pool)
        tp = pool0.total_pages
        self._telem_last = np.zeros((2, self.n_shards, tp), np.int64)
        # each shard's (src, dst) migration lanes of the next step,
        # scratch when idle
        self._mig_h = np.full((self.n_shards, 2, self._mig_slots),
                              pool0.scratch_id, np.int64)
        # host seconds per step of the loop's host half (fold, plan and
        # finalize)
        self.heal_seconds: List[float] = []
        # host seconds per step of the ranks' control-plane exchange
        self.exchange_seconds: List[float] = []

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
            self.metrics = MetricsRegistry(self.n_shards, pool0,
                                           config=self.obs,
                                           layouts=self.layout_kinds)
            self.trace = EventTrace(capacity=self.obs.trace_capacity)
            for sh in self._shards:
                sh.pool.on_event = functools.partial(self._pool_event,
                                                     sh.index)

        # Device state: the page tables of every slot (shard k owns rows
        # k * slots_per_shard ..), shard 0's pool tree (each shard's is
        # its ``tree``).  Per-step lanes (tokens, positions) are built on
        # the host, which knows them, and the decode-only step reads them
        # from its static buffers.
        dev = self.device
        self.state = {
            "pool": self._shards[0].tree,
            "ptab": torch.full((s, pool0.n_logical_pages), pool0.scratch_id,
                               dtype=torch.int32, device=dev),
        }
        inputs = {
            "tok": torch.zeros((s, 1), dtype=torch.int64, device=dev),
            "pos": torch.full((s,), -1, dtype=torch.int32, device=dev),
            "wstart": torch.zeros((s,), dtype=torch.int32, device=dev)}
        if self.heal is not None:
            inputs["mig"] = torch.from_numpy(self._mig_h).to(dev)
            # per-shard, per-page corrected / uncorrectable codewords,
            # accumulated
            telem = torch.zeros((2, self.n_shards, tp), dtype=torch.int32,
                                device=dev)
            self._telem = telem
            self.state["telem"], self.state["telem_u"] = telem[0], telem[1]
        self._decode = CapturedStep(self._decode_body, dev, inputs=inputs,
                                    capture=capture)
        if self.obs.enabled:
            # counters live on the host, where the step is driven
            self.state["mtr"] = init_step_counters(self.n_shards)

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
    def rank(self) -> int:
        """This process's rank (0 off a process group)."""
        return 0 if self.rank_group is None else self.rank_group.rank

    @property
    def n_active(self) -> int:
        return sum(1 for r in self._slots if r is not None)

    def shard_active(self, k: int) -> int:
        s = self.slots_per_shard
        return sum(1 for r in self._slots[k * s:(k + 1) * s]
                   if r is not None)

    def shard_plan(self, k: int):
        """Shard ``k``'s undervolt plan (its own fault-map seed): the plan
        a standalone ``generate()`` replay of a request served on shard
        ``k`` must run against."""
        return self._shards[k].plan

    def _rows(self, k: int) -> slice:
        """Shard ``k``'s global slot range."""
        s = self.slots_per_shard
        return slice(k * s, (k + 1) * s)

    def _free_slot_in(self, k: int) -> Optional[int]:
        rows = self._rows(k)
        for g in range(rows.start, rows.stop):
            if self._slots[g] is None:
                return g
        return None

    def _plan_pages(self, k: int, req: Request, prompt: np.ndarray,
                    n_new: int) -> _AdmitPlan:
        """Match the prompt against shard ``k``'s prefix cache, retain the
        shared pages and allocate the rest: pages that will hold prompt
        rows and be published at the transition under ``shared_prefix``,
        the rest under the request's tier.  Raises CapacityError with
        every side effect rolled back."""
        p = self._shards[k].pool
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

    def _rollback(self, k: int, plan: _AdmitPlan, rid) -> None:
        p = self._shards[k].pool
        if plan.fs:
            p.release(plan.retained, ("__req__", rid))
        p.free(plan.row[plan.fs:])

    def _n_new(self, req: Request) -> int:
        return int(req.max_new_tokens if req.max_new_tokens is not None
                   else self.sc.max_new_tokens)

    def _shard_order(self) -> List[int]:
        """Admission routing: shards with a free slot, most free pages
        first (ties to the lowest index) -- page-level load balancing that
        also spreads tenants across fault maps."""
        order = [k for k in range(self.n_shards)
                 if self._free_slot_in(k) is not None]
        order.sort(key=lambda k: (-self._shards[k].pool.free_pages, k))
        return order

    def _govern(self, k: int, plan: _AdmitPlan, rid) -> bool:
        """The governor's half of an admission on shard ``k``: the
        deepest voltage at which the shard's whole post-admission working
        set (not just the new request's cache) stays on usable PCs, under
        the shard's setpoint.  On CapacityError the setpoint may escalate
        once (:meth:`_escalate_setpoint`) and the admission retry; else
        the pages are rolled back and the admission is backpressure
        (False)."""
        sh = self._shards[k]
        need = (self.shard_active(k) + 1) * sh.pool.request_words * 4
        try:
            v = float(sh.governor.admit(need, setpoint=sh.setpoint))
        except CapacityError:
            try:
                if not self._escalate_setpoint(k):
                    raise
                v = float(sh.governor.admit(need, setpoint=sh.setpoint))
            except CapacityError:
                self._rollback(k, plan, rid)
                return False
        if v != sh.voltage:
            sh.voltage = v
            self._refresh_tables(sh)
        return True

    def _refresh_tables(self, sh: _Shard) -> None:
        """Rewrite a shard's static threshold tables, in place, at its
        current voltage with its chaos marks (on the rank that holds
        them)."""
        if sh.local:
            sh.kvc.load_tables(sh.tables, sh.voltage,
                               sh.chaos if sh.chaos.any() else None)

    def _try_admit_on(self, k: int, req: Request, prompt: np.ndarray,
                      n_new: int) -> bool:
        """One shard's whole admission attempt (pages, then governor),
        rolled back and reported as False on backpressure."""
        g = self._free_slot_in(k)
        if g is None:
            return False
        plan = None
        while plan is None:
            try:
                plan = self._plan_pages(k, req, prompt, n_new)
            except CapacityError:
                if not self._shards[k].pool.evict_prefix():
                    return False
        if (self._shards[k].governor is not None
                and not self._govern(k, plan, req.rid)):
            return False
        self.queue.popleft()
        self._admit(req, g, plan, prompt)
        return True

    def admit_pending(self) -> int:
        """Admit queued requests FIFO until every shard's slots, page pool
        or governor push back (evicting idle prefix-cache entries before
        giving up).  Returns the number admitted."""
        n = 0
        while self.queue and self.n_active < self.max_active:
            req = self.queue[0]
            prompt = np.asarray(req.tokens, np.int32).reshape(-1)
            if not any(self._try_admit_on(k, req, prompt, self._n_new(req))
                       for k in self._shard_order()):
                self._emit("backpressure", rid=req.rid,
                           queued=len(self.queue), active=self.n_active)
                break
            n += 1
        return n

    def _admit(self, req: Request, g: int, plan: _AdmitPlan,
               prompt: np.ndarray) -> None:
        k = g // self.slots_per_shard
        sh = self._shards[k]
        p = sh.pool
        plen = prompt.shape[0]
        # scrub the freshly allocated pages (stale-tenant data) and COW-copy
        # the shared boundary page's clean prompt rows; retained shared
        # entries are passed as scratch (a reset there is harmless)
        reset_row = plan.row.copy()
        reset_row[:plan.fs] = p.scratch_id
        if sh.local:
            sh.kvc.reset_and_fork(
                sh.tree, reset_row, plan.fork_src,
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
            voltage=(sh.voltage if p.placement is not None else None),
            pages_shared=plan.fs, shard=k)
        self.admitted += 1
        self.peak_active = max(self.peak_active, self.n_active)
        self._emit("admission", shard=k, rid=req.rid, plen=int(plen),
                   n_new=self._remaining[req.rid],
                   pages_shared=int(plan.fs),
                   voltage=(sh.voltage if p.placement is not None
                            else None))
        if plan.fork_rows:
            self._emit("cow_fork", shard=k, rid=req.rid,
                       src=int(plan.fork_src), dst=int(plan.row[plan.fs]),
                       rows=int(plan.fork_rows))

    def _transition(self, g: int) -> None:
        """Prefill finished this step: publish shareable pages, inject the
        request's pages (the standalone ``init_inject`` twin) and flip the
        slot to the decode phase."""
        rid = self._slots[g]
        plan = self._slot_plan[g]
        sh = self._shards[g // self.slots_per_shard]
        p = sh.pool
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
        if self.active and sh.local:
            # private pages take the mode's full treatment; pages that are
            # (or just became) shared keep their K/V clean in every mode and
            # only their pos bookkeeping takes write-path faults
            nsh = plan.cover if plan.eligible else 0
            sh.kvc.inject_pages(sh.tree, self._slot_priv[g], sh.voltage,
                                method=sh.method,
                                skip_kv=(self.mode == "read"))
            sh.kvc.inject_pages(sh.tree, plan.row[:nsh], sh.voltage,
                                method=sh.method, skip_kv=True)
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
        k = g // self.slots_per_shard
        p = self._shards[k].pool
        rid = self._slots[g]
        res = self._meta.pop(rid)
        res.tokens = np.asarray(self._out.pop(rid), np.int32)[None, :]
        self.results[rid] = res
        self._emit("retirement", shard=k, rid=rid,
                   tokens=int(res.tokens.shape[1]),
                   ttft_steps=res.ttft_steps)
        if len(self._slot_shared[g]):
            p.release(self._slot_shared[g], ("__req__", rid))
        if len(self._slot_priv[g]):
            p.free(self._slot_priv[g])
        del self._remaining[rid]
        del self._admit_step[rid]
        self._slots[g] = None
        self._slot_priv[g] = None
        self._slot_shared[g] = None
        self._slot_plan[g] = None
        self._ptoks[g] = None
        self._gen[g] = None
        self._dec_h[g] = True
        self.state["ptab"][g] = p.scratch_id

    def _decode_body(self):
        """The decode-only step over every serving slot of this process's
        shards, from the static buffers, one shard after another: the
        model step over the shard's slots and pool (idle slots at position
        -1 write to the scratch page), the masked write-path injection and,
        greedy, the argmax.  Returns the tokens of those slots (``_local_
        rows``), or their logits when sampling."""
        inp = self._decode.inputs
        outs = []
        for sh in self._local_shards:
            rows = self._rows(sh.index)
            ptab, pos = self.state["ptab"][rows], inp["pos"][rows]
            if self.heal is not None:
                self._migrate_in_step(sh, ptab, inp["mig"][sh.index])
            ctx = sh.kvc.make_ctx(ptab, sh.tables, method=sh.method,
                                  inject=self.active,
                                  wstart=inp["wstart"][rows])
            logits, _ = self.bundle.module.decode_step(
                self.params, sh.tree, {"tokens": inp["tok"][rows]}, pos,
                self.cfg, fault_ctx=ctx)
            if self.active:
                sh.kvc.post_step_inject(sh.tree, ptab, pos, sh.tables,
                                        mode=self.mode, method=sh.method)
            if self.heal is not None:
                self._scrub(sh, ptab)
            outs.append(logits)
        logits = torch.cat(outs) if len(outs) > 1 else outs[0]
        if self.sc.temperature <= 0.0:
            return sample_tokens(logits, 0.0)
        return logits

    def _migrate_in_step(self, sh: _Shard, ptab, mig) -> None:
        """The device half of a shard's migrations this step, before the
        decode read: copy each staged page to its target, then rewrite
        every entry of the shard's page-table rows naming a source, in
        place.  Idle lanes hold the scratch id, which the rewrite must not
        match (idle rows of the page table legitimately hold it)."""
        src, dst = mig[0], mig[1]
        sh.kvc.migrate_pages(sh.tree, src, dst)
        moving = src != sh.pool.scratch_id
        eq = (ptab[:, :, None] == src[None, None, :]) & moving[None, None, :]
        repl = torch.where(eq, dst[None, None, :], 0).sum(-1)
        ptab.copy_(torch.where(eq.any(-1), repl.to(ptab.dtype), ptab))

    def _scrub(self, sh: _Shard, ptab) -> None:
        """A shard's telemetry scrub after the write path: this step's
        per-page SECDED counts over every page its slots reference, added
        to the static counters."""
        corr, bad = sh.kvc.scrub_telemetry(sh.tree, ptab, sh.tables)
        self._telem[0, sh.index] += corr
        self._telem[1, sh.index] += bad

    def _mixed_step(self, tok, pos, cols, wstart, pref, starts, ends, dec):
        """A step with prefilling slots, eager, one of this process's
        shards after another: the prompt chunks and the decoding slots'
        tokens in ``prefill_chunk`` columns.  Returns the logits of each
        of those slots' (``_local_rows``) sampled column."""
        dev = self.device
        tok, pos = torch.from_numpy(tok).to(dev), torch.from_numpy(pos).to(dev)
        cols = torch.from_numpy(cols).to(dev)
        wstart = torch.from_numpy(wstart).to(dev)
        outs = []
        for sh in self._local_shards:
            rows = self._rows(sh.index)
            lo = rows.start
            ptab = self.state["ptab"][rows]
            if self.heal is not None:
                self._migrate_in_step(sh, ptab,
                                      self._decode.inputs["mig"][sh.index])
            mine = [i for i, g in enumerate(pref)
                    if rows.start <= g < rows.stop]
            ctx = sh.kvc.make_ctx(
                ptab, sh.tables, method=sh.method, inject=self.active,
                wstart=wstart[rows],
                prefill_slots=[pref[i] - lo for i in mine],
                prefill_start=[starts[i] for i in mine],
                prefill_end=[ends[i] for i in mine])
            logits, _ = self.bundle.module.decode_step(
                self.params, sh.tree, {"tokens": tok[rows]}, pos[rows],
                self.cfg, fault_ctx=ctx, logit_cols=cols[rows])
            dec_k = [g for g in dec if rows.start <= g < rows.stop]
            if self.active and dec_k:
                # write-path injection covers only decoding slots' writes;
                # prefill writes stay clean until the transition injection
                qpos = np.full(self.slots_per_shard, -1, np.int32)
                qpos[[g - lo for g in dec_k]] = [self._qpos_h[g]
                                                 for g in dec_k]
                sh.kvc.post_step_inject(sh.tree, ptab,
                                        torch.from_numpy(qpos).to(dev),
                                        sh.tables, mode=self.mode,
                                        method=sh.method)
            if self.heal is not None:
                self._scrub(sh, ptab)
            outs.append(logits)
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def _counter_deltas(self, live, pref):
        """Each shard's in-step metric increments of the coming step, from
        the pre-step phase and cursors (the reference's in-step delta)."""
        s = self.num_slots
        act = torch.zeros(s, dtype=torch.bool)
        act[live] = True
        is_dec = torch.ones(s, dtype=torch.bool)
        is_dec[pref] = False
        cursor = torch.tensor(self._cursor_h, dtype=torch.int32)
        plen = torch.tensor(self._plen_h, dtype=torch.int32)
        wstart = torch.tensor(self._wstart_h, dtype=torch.int32)
        out = []
        for sh in self._shards:
            r = self._rows(sh.index)
            out.append(step_counter_delta(
                act=act[r], dec=is_dec[r], cursor=cursor[r], plen=plen[r],
                wstart=wstart[r], chunk=self.chunk,
                n_logical_pages=sh.pool.n_logical_pages,
                mig_src=torch.from_numpy(self._mig_h[sh.index, 0]),
                scratch_id=sh.pool.scratch_id))
        return out

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
            deltas = self._counter_deltas(live, pref)
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
            sampling = [g for g in dec + [
                g for g in pref if self._plen_h[g] - self._cursor_h[g] <= c]
                if g in self._row_pos]
            toks = np.zeros(s, np.int64)
            if greedy:                 # out: the local slots' tokens
                toks[self._local_rows] = out.cpu().numpy()
            else:                      # out: the local slots' logits
                picked = [sample_tokens(
                    out[self._row_pos[g]:self._row_pos[g] + 1],
                    self.sc.temperature, self._gen[g]) for g in sampling]
                if picked:
                    toks[sampling] = torch.cat(picked).cpu().numpy()
        seconds = time.perf_counter() - t0
        self.step_seconds["mixed" if pref else "decode"].append(seconds)
        if self.metrics is not None:
            self.metrics.record_step(seconds)
            for k, delta in enumerate(deltas):
                self.state["mtr"][k] += delta
        self.steps += 1
        telem = None
        if self.heal is not None:
            # one D2H copy after the token read: no sync inside the step
            telem = self._telem.cpu().numpy().astype(np.int64)
        if self.rank_group is not None:
            self._exchange(toks, telem)
        if self.heal is not None:
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

    def _exchange(self, toks: np.ndarray, telem) -> None:
        """The ranks' control-plane exchange after a step: every rank's
        tokens of its slots and, under self-healing, its shards' telemetry
        rows, gathered in place into ``toks`` and ``telem``."""
        t0 = time.perf_counter()
        mine = [k for k in range(self.n_shards)
                if self._owners[k] == self.rank]
        got = self.rank_group.all_gather_object(
            (toks[self._local_rows],
             None if telem is None else telem[:, mine]))
        for r, (t, tel) in enumerate(got):
            toks[self._rank_rows[r]] = t
            if telem is not None:
                telem[:, [k for k in range(self.n_shards)
                          if self._owners[k] == r]] = tel
        self.exchange_seconds.append(time.perf_counter() - t0)

    # ---- self-healing loop, host half ----------------------------------
    @property
    def posterior(self):
        """Shard 0's fault-map posterior (``_shards[k].posterior`` for
        shard ``k``)."""
        return self._shards[0].posterior

    @property
    def allocator(self):
        """Shard 0's adopted allocator."""
        return self._shards[0].allocator

    @property
    def suspects(self) -> set:
        """Shard 0's suspect (pc, DRAM row) pairs after the last step."""
        return self._shards[0].suspects

    @property
    def retired_blocks(self) -> set:
        """Shard 0's (pc, arena block) pairs retired through its
        allocator."""
        return self._shards[0].retired_blocks

    @property
    def migrations(self) -> int:
        """Page migrations applied, over every shard."""
        return sum(sh.migrations for sh in self._shards)

    @property
    def telemetry(self) -> np.ndarray:
        """(2, total_pages) corrected / uncorrectable codewords counted per
        page of shard 0 up to the last step, as read on the host after it
        (``_telem_last[:, k]`` for shard ``k``)."""
        return self._telem_last[:, 0]

    def _escalate_setpoint(self, k: int) -> bool:
        """Raise shard ``k``'s governor rate setpoint one decade (up to the
        configured cap): the graceful-degradation response to an admission
        CapacityError once quarantine has eaten into the frontier.
        Returns False when escalation does not apply (no self-healing, no
        setpoint, nothing quarantined, a power-mode governor, or already
        at the cap)."""
        sh = self._shards[k]
        if (self.heal is None or sh.governor is None
                or sh.setpoint is None
                or sh.governor.config.mode not in ("rate", "adaptive",
                                                   "efficiency")
                or not sh.pool.quarantined_pages):
            return False
        cap = float(self.heal.setpoint_cap)
        if sh.setpoint >= cap:
            return False
        old = sh.setpoint
        sh.setpoint = min(sh.setpoint * 10.0, cap)
        sh.setpoint_escalations += 1
        self._emit("escalation", shard=k, setpoint_from=old,
                   setpoint_to=sh.setpoint)
        return True

    def weaken_row(self, k: int, pc: int, row: int) -> np.ndarray:
        """Chaos hook: DRAM row ``row`` of shard ``k``'s pseudo-channel
        ``pc`` goes weak at runtime -- every page of the shard's pool whose
        K/V payload overlaps it reads through weak-rate thresholds from
        the next step on (read path and scrub only; stored data stays
        clean, so replays stay exact).  Returns the affected page ids.
        The shard's tables are rewritten in place; the captured step is
        untouched."""
        if self.heal is None:
            raise ValueError(
                "weaken_row needs self_heal=SelfHealConfig(...): the chaos "
                "mask and telemetry lanes only exist under the self-healing "
                "loop")
        if not 0 <= int(k) < self.n_shards:
            raise ValueError(f"shard {k} out of range [0, {self.n_shards})")
        sh = self._shards[int(k)]
        pids = sh.pool.pages_on_row(int(pc), int(row))
        if len(pids):
            sh.chaos[pids] = True
            self._refresh_tables(sh)
        return pids

    def _plan_self_heal(self) -> None:
        """Before the step, per shard: walk the suspect rows, quarantine
        free victim pages outright and stage up to ``max_migrations``
        live-page migrations into the shard's lanes (targets freshly
        allocated off suspect rows)."""
        heal = self.heal
        for sh in self._shards:
            if not sh.suspect_keys.size or sh.pending_mig:
                continue
            p = sh.pool
            pages = p.pages_on_rows(sh.suspect_keys)
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
                            # keep serving on the suspect page, retry next
                            # step
                            sh.migration_stalls += 1
                            break
                    if cand in seen:
                        rejects.append(cand)    # the target is suspect too
                        continue
                    dst = cand
                if dst is None:
                    break
                pairs.append((src, dst))
            if rejects:
                p.quarantine(rejects)
            if not pairs:
                continue
            for i, (src, dst) in enumerate(pairs):
                self._mig_h[sh.index, :, i] = (src, dst)
            sh.pending_mig = pairs

    def _finalize_self_heal(self) -> None:
        """After the step, which applied the staged migrations on the
        device, per shard: commit the host accounting (pool ownership and
        holders, every host page-id array, each live request's replay
        placement), then retire drained quarantined blocks through the
        adopted allocator."""
        for sh in self._shards:
            k, p, pairs = sh.index, sh.pool, sh.pending_mig
            if pairs:
                for src, dst in pairs:
                    p.migrate(src, dst)
                    self._emit("migration", shard=k, src=int(src),
                               dst=int(dst))
                sh.migrations += len(pairs)

                def rewrite(arr):
                    if arr is not None and len(arr):
                        for src, dst in pairs:
                            arr[arr == src] = dst

                rows = self._rows(k)
                for g in range(rows.start, rows.stop):
                    rid = self._slots[g]
                    if rid is None:
                        continue
                    rewrite(self._slot_priv[g])
                    rewrite(self._slot_shared[g])
                    rewrite(self._slot_plan[g].row)
                    rewrite(self._slot_plan[g].retained)
                    # only live requests move: a retired request's
                    # placement is its decode-time history
                    meta = self._meta[rid]
                    rewrite(meta.page_ids)
                    meta.placement = p.request_placement(meta.page_ids)
                self._mig_h[k] = p.scratch_id
                sh.pending_mig = []
            keys = p.retirable_block_keys()
            new = keys[~np.isin(keys, sh.retired_keys)]
            if new.size:
                sh.allocator.quarantine(p.block_segments(new))
                sh.retired_keys = np.union1d(sh.retired_keys, new)
                for pc, blk in zip(*np.divmod(
                        new, sh.allocator.blocks_per_pc)):
                    self._emit("block_retire", shard=k, pc=int(pc),
                               block=int(blk))

    def _fold_telemetry(self, telem: np.ndarray) -> None:
        """Diff the (2, n_shards, total_pages) telemetry counters read
        after the step and fold each changed page's counts into its
        shard's posterior, over the page's rows (pages ascending, each
        page's rows sorted, as the reference folds them); refresh the
        suspect set and re-plan an adaptive governor when it moves."""
        d = telem - self._telem_last
        self._telem_last = telem
        for sh in self._shards:
            k, p = sh.index, sh.pool
            hits = np.flatnonzero((d[0, k] > 0) | (d[1, k] > 0))
            if len(hits):
                keys, counts = p.page_row_keys(hits)
                pcs, rows = np.divmod(keys, p.faultmap.rows_per_pc)
                sh.posterior.observe_many(
                    pcs, rows, np.repeat(d[0, k, hits], counts),
                    np.repeat(d[1, k, hits], counts), p.page_codewords(),
                    sh.voltage)
            new = sh.posterior.suspect_keys(sh.voltage,
                                            self.heal.suspect_threshold)
            if not np.array_equal(new, sh.suspect_keys):
                sh.suspect_keys = new
                if (sh.governor is not None
                        and sh.governor.config.mode == "adaptive"):
                    sh.governor.replan(sh.posterior)
                    self._emit("replan", shard=k, suspect_rows=len(new))

    def run(self) -> Dict[Any, RequestResult]:
        """Drain the queue: admit / step / retire until every submitted
        request has finished.  Returns ``results``."""
        while self.queue or self.n_active:
            self.admit_pending()
            if not self.n_active:
                if not self.queue:
                    break
                # nothing running anywhere and the head request still
                # cannot be admitted: it can never fit.  Re-run its
                # admission on the best-provisioned shard so the capacity
                # source raises its own error, naming the shard
                req = self.queue[0]
                prompt = np.asarray(req.tokens, np.int32).reshape(-1)
                k = max(range(self.n_shards),
                        key=lambda i: self._shards[i].pool.free_pages)
                sh = self._shards[k]
                plan = self._plan_pages(k, req, prompt, self._n_new(req))
                self._rollback(k, plan, req.rid)
                if sh.governor is not None:
                    sh.governor.admit(sh.pool.request_words * 4,
                                      setpoint=sh.setpoint)
                raise CapacityError(
                    "scheduler", sh.pool.request_words * 4,
                    sh.pool.free_pages * sh.pool.page_set_words * 4,
                    "admission stuck with an idle pool",
                    shard=sh.pool.shard)
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
    def voltage(self) -> float:
        """Shard 0's KV-domain voltage (``stats['shards']`` for each)."""
        return self._shards[0].voltage

    @property
    def pricing_voltages(self) -> List[float]:
        """Per shard, the rail the energy accountant prices HBM traffic
        at: the operating voltage of a placed (undervolted) shard, nominal
        for a clean one."""
        return [sh.voltage if sh.pool.placement is not None else V_NOM
                for sh in self._shards]

    @property
    def pricing_voltage(self) -> float:
        """Shard 0's :attr:`pricing_voltages` entry."""
        return self.pricing_voltages[0]

    @property
    def stats(self) -> Dict[str, Any]:
        shards = [{
            "shard": sh.index,
            "active": self.shard_active(sh.index),
            "free_pages": sh.pool.free_pages,
            "weak_pages": sh.pool.num_weak_pages,
            "shared_pages": sh.pool.shared_pages,
            "voltage": sh.voltage,
            "setpoint": sh.setpoint,
            "map_seed": sh.seed,
        } for sh in self._shards]
        if self.heal is not None:
            for row, sh in zip(shards, self._shards):
                post = sh.posterior.stats()
                row.update(
                    corrected=post["corrected"],
                    uncorrectable=post["uncorrectable"],
                    tracked_rows=post["tracked_rows"],
                    suspect_rows=int(sh.suspect_keys.size),
                    migrations=sh.migrations,
                    migration_stalls=sh.migration_stalls,
                    quarantined_pages=len(sh.pool.quarantined_pages),
                    quarantined_blocks=len(sh.allocator.quarantined_blocks),
                    setpoint_escalations=sh.setpoint_escalations,
                    governor_replans=(sh.governor.replans
                                      if sh.governor is not None else 0))
        out = {
            "route": "paged",
            "cache_layouts": list(self.layout_kinds),
            "steps": self.steps,
            "admitted": self.admitted,
            "peak_active": self.peak_active,
            "free_pages": sum(r["free_pages"] for r in shards),
            "weak_pages": sum(r["weak_pages"] for r in shards),
            "voltage": self.voltage,
            "prefill_chunk": self.chunk,
            "shared_pages": sum(r["shared_pages"] for r in shards),
            "prefix_entries": sum(sh.pool.prefix_entries
                                  for sh in self._shards),
            "n_shards": self.n_shards,
            "decode_traces": self._decode.traces,
        }
        if self.heal is not None:
            for key in ("corrected", "uncorrectable", "migrations",
                        "quarantined_pages", "quarantined_blocks",
                        "setpoint_escalations"):
                out[key] = sum(r[key] for r in shards)
        out["shards"] = shards
        if self.governor is not None:
            out["fleet"] = fleet_report(
                [sh.governor for sh in self._shards],
                [sh.voltage for sh in self._shards],
                [sh.setpoint for sh in self._shards])
        if self.metrics is not None:
            out["obs"] = self.metrics.snapshot(
                self.state, voltages=self.pricing_voltages)
        if self.trace is not None:
            out["events"] = dict(self.trace.counts)
        return out
