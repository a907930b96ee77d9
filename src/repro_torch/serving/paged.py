"""Paged KV cache: serving-cache pages carved out of HBM arena blocks
(port of :mod:`repro.serving.paged`).

  * A :class:`PagePool` carves fixed-size KV pages out of the placement's
    arena blocks.  A page size divides the block size, so every page sits
    inside one block and inherits its pseudo-channel: the per-page
    physical tables are an index refinement of the block tables
    (:func:`repro_torch.core.engine.refine_tables`).  Pages are handed
    out by criticality tier (weak-row pages to tolerant requests first,
    weak-avoiding tiers get strong pages most-reliable-first); exhaustion
    raises :class:`~repro_torch.core.domains.CapacityError`, the
    scheduler's backpressure signal.  Pages are refcounted for
    copy-on-write prompt-prefix sharing.
  * A :class:`PagedKVCache` owns the pool's device buffers (the pool is
    ``cache_specs(cfg, num_pages + 1, page_slots)``: a ring cache whose
    batch rows are pages) and the serving-side data paths, all in place:
    the admission reset and copy-on-write fork, the prefill->decode
    transition injection and the per-step write-path injection of exactly
    the words a step wrote (plain PyTorch through
    :func:`repro_torch.core.engine.corrupt_words`).
  * A :class:`PagedServingCtx` is the decode-step hook (the protocol of
    :class:`repro_torch.serving.readpath.ReadPathCtx`): the pool-page
    write and attention through the paged kernel K4
    (:func:`repro_torch.kernels.flash_attention.faulty.
    paged_decode_attention`), which corrupts each page as it loads it.
    :class:`MixedServingCtx` adds chunked-prefill lanes.
  * :meth:`PagePool.request_placement` exports one request's pages as a
    page-granular placement of its standalone cache, so ``generate(...,
    kv_placement=...)`` replays the request on the same physical words.

Not ported yet: self-healing (``quarantine``, ``migrate``,
``scrub_telemetry``, the chaos hook; ROADMAP slice 9) and the sliding-
window ring stash of chunked prefill (slice 12).
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import engine as arena
from repro_torch.core import hashing as H
from repro_torch.core import pytree
from repro_torch.core.domains import CapacityError, MemoryDomain, resolve_tier
from repro_torch.core.faultmap import NUM_THR_COLS, FaultMap
from repro_torch.kernels.bitflip.bitflip import BLOCK_WORDS
from repro_torch.kernels.flash_attention import faulty
from repro_torch.models import cache as C
from repro_torch.models import layers as L
from repro_torch.models.base import cache_layouts, cache_slot_axes, spec_avals

# Pool-cache leaves: the shared attention-cache layout (stack containers
# x ring k/v/pos leaves).
_LEAF_RE = re.compile(
    r"^\['(prefix|periods|rest)'\]\['([^']+)'\]\['(k|v|pos)'\]$")


class PagedLayoutError(ValueError):
    """A cache layout that cannot be paged: page size not dividing the
    arena block size, ECC-incompatible page geometry, a non-ring leaf."""


class PageSharingError(ValueError):
    """A refcounted-page protocol violation: double release, retaining or
    forking a page that is not shared, re-sharing a shared page, or
    ``free()`` of a page that still has holders."""


@dataclasses.dataclass(frozen=True, eq=False)
class PagedLeafPlacement:
    """Page-granular placement of one leaf of a request's standalone
    (contiguous, B=1) cache: entry ``j`` of the tables describes leaf
    words ``[j * page_words, (j+1) * page_words)``."""

    path: str
    n_words: int
    page_words: int
    page_base: np.ndarray      # (n_pages,) uint32 physical base words
    page_pc: np.ndarray        # (n_pages,) int32 owning pseudo-channel


@dataclasses.dataclass(frozen=True, eq=False)
class RequestPlacement:
    """One request's cache placement assembled from its pool pages; it
    quacks like a GroupPlacement for the serving engine, addressing
    physical words through per-leaf page tables."""

    group: str
    domain: MemoryDomain
    leaves: Tuple[PagedLeafPlacement, ...]
    # seed of the exporting pool's fault map, checked by readpath.build_ctx
    map_seed: Optional[int] = None

    @property
    def total_words(self) -> int:
        return sum(l.n_words for l in self.leaves)


@dataclasses.dataclass(frozen=True, eq=False)
class _PoolLeaf:
    """Static metadata of one pool-cache leaf."""

    path: str
    container: str             # prefix | periods | rest
    slot_key: str              # e.g. "s0_global"
    which: str                 # k | v | pos
    stacked: bool              # leading period axis
    n_layers: int              # 1 for unstacked leaves
    wps: int                   # uint32 words per cache slot
    page_words: int            # wps * page_slots
    layer_words: int           # words per layer slice of the pool leaf
    length: int                # logical ring length (max_len or window)
    n_pages: int               # length // page_slots
    layout: str                # "full" | "window"
    # Physical tables (None when the pool is unplaced / clean):
    page_base: Optional[np.ndarray]   # (n_layers, total_pages) uint32
    page_pc: Optional[np.ndarray]     # (n_layers, total_pages) int32


def _leaf_words_per_slot(shape, slot_axis, dtype) -> int:
    inner = int(np.prod(shape[slot_axis + 1:], dtype=np.int64))
    nbytes = inner * dtype.itemsize
    if nbytes % 4:
        raise PagedLayoutError(
            f"cache slot of {inner} x {dtype} elements is not word-aligned; "
            "the paged cache needs whole uint32 words per slot")
    return nbytes // 4


def unported(what: str, slice_no: int, name: str):
    """Raise for a feature of the reference that a later slice ports."""
    raise NotImplementedError(
        f"{what} arrives with the {name} slice of the port (ROADMAP slice "
        f"{slice_no})")


class PagePool:
    """Host-side page allocator over one serving cache pool.

    ``num_pages`` usable pages plus one trailing *scratch* page
    (``scratch_id``), the write sink of inactive serving slots, never
    handed out.  A page id is valid across every leaf and layer at once.
    Tier routing: pages whose K/V payload overlaps a weak DRAM row are
    *weak*; weak-avoiding tiers take strong pages most-reliable-first,
    tolerant tiers take weak pages first and then strong pages
    least-reliable-first.
    """

    def __init__(self, module, cfg, *, max_len: int, page_slots: int,
                 num_pages: int, plan=None, shard=None):
        if not getattr(module, "SUPPORTS_PAGED", False):
            raise ValueError(
                f"family module {getattr(module, '__name__', module)!r} "
                "does not support the paged serving cache")
        if page_slots <= 0 or max_len % page_slots:
            raise PagedLayoutError(
                f"page_slots={page_slots} must positively divide "
                f"max_len={max_len} (ServeConfig.max_len)")
        self.module = module
        self.cfg = cfg
        self.max_len = int(max_len)
        self.page_slots = int(page_slots)
        self.num_pages = int(num_pages)
        self.total_pages = self.num_pages + 1
        self.scratch_id = self.num_pages
        self.plan = plan
        self.shard = shard
        self.pool_specs = module.cache_specs(cfg, self.total_pages,
                                             self.page_slots)
        self.pool_avals = spec_avals(self.pool_specs)
        placed = (plan is not None and plan.enabled
                  and plan.covers("kv_cache"))
        if placed:
            self.placement = plan.place(
                {"kv_cache": self.pool_avals})["kv_cache"]
            self.domain = self.placement.domain
            self.faultmap: Optional[FaultMap] = plan.fault_map()
        else:
            self.placement = None
            self.domain = None
            self.faultmap = None
        self.leaves = self._build_leaves()
        self.n_logical_pages = max(l.n_pages for l in self.leaves)
        self.page_set_words = sum(l.n_layers * l.page_words
                                  for l in self.leaves)
        self.request_words = self.n_logical_pages * self.page_set_words

        weak, rate = self._page_classes()
        order = sorted(range(self.num_pages), key=lambda p: (rate[p], p))
        self._strong: List[int] = [p for p in order if not weak[p]]
        self._weak: List[int] = [p for p in order if weak[p]]
        self._weak_set = set(self._weak)
        self._rate = rate
        self._owned: set = set()
        self._shared: Dict[int, set] = {}
        self._prefix: Dict[bytes, np.ndarray] = {}
        # callable(kind, **data) the scheduler installs to trace events
        self.on_event = None

    # ---- static layout ---------------------------------------------------
    def _build_leaves(self) -> Tuple[_PoolLeaf, ...]:
        avals = dict((pytree.keystr(p), a) for p, a in
                     pytree.flatten_with_path(self.pool_avals))
        axes = dict((pytree.keystr(p), a) for p, a in
                    pytree.flatten_with_path(cache_slot_axes(self.pool_specs)))
        req_specs = self.module.cache_specs(self.cfg, 1, self.max_len)
        req_avals = dict((pytree.keystr(p), a) for p, a in
                         pytree.flatten_with_path(spec_avals(req_specs)))
        req_axes = dict((pytree.keystr(p), a) for p, a in
                        pytree.flatten_with_path(cache_slot_axes(req_specs)))
        req_lay = dict((pytree.keystr(p), a) for p, a in
                       pytree.flatten_with_path(
                           cache_layouts(req_specs, self.max_len)))
        leaf_meta = {}
        for path, aval in req_avals.items():
            lay = req_lay[path]
            if lay in ("state", "cross"):
                raise PagedLayoutError(
                    f"cache leaf {path} has layout {lay!r}: carried state "
                    "and cross-attention leaves cannot live in the page "
                    "pool (the state arena serves them, ROADMAP slice 12)")
            length = aval.shape[req_axes[path]]
            if self.page_slots > length:
                raise PagedLayoutError(
                    f"cache leaf {path}: page_slots={self.page_slots} "
                    f"exceeds the {lay!r} ring length {length} (cfg.window);"
                    f" a page must fit inside the ring -- pick page_slots "
                    f"<= {length}")
            if length % self.page_slots:
                field = ("cfg.window" if lay == "window"
                         else "ServeConfig.max_len")
                raise PagedLayoutError(
                    f"cache leaf {path}: page_slots={self.page_slots} does "
                    f"not divide the leaf's ring length {length} ({field})")
            leaf_meta[path] = (length, lay)

        placed = self.placement is not None
        tabs = arena.leaf_block_tables(self.placement) if placed else None
        paths = ([lp.path for lp in self.placement.leaves] if placed
                 else None)
        ecc = placed and self.domain.ecc
        out = []
        for path in sorted(avals):
            m = _LEAF_RE.match(path)
            if not m:
                raise PagedLayoutError(
                    f"cache leaf {path} is not a ring k/v/pos leaf of the "
                    "shared attention-cache layout")
            aval, ax = avals[path], axes[path]
            stacked = m.group(1) == "periods"
            if ax != (2 if stacked else 1):
                raise PagedLayoutError(
                    f"cache leaf {path}: slot axis {ax} is not the ring "
                    "axis the paged layout expects")
            length, layout = leaf_meta[path]
            n_layers = aval.shape[0] if stacked else 1
            wps = _leaf_words_per_slot(aval.shape, ax, aval.dtype)
            page_words = wps * self.page_slots
            if BLOCK_WORDS % page_words:
                raise PagedLayoutError(
                    f"cache leaf {path}: page size {page_words} words "
                    f"({self.page_slots} slots x {wps} words) does not "
                    f"divide the arena block size ({BLOCK_WORDS} words)")
            if ecc and (page_words % 2 or
                        (m.group(3) in ("k", "v") and wps % 2)):
                raise PagedLayoutError(
                    f"cache leaf {path}: ECC domains need even page and "
                    f"slot word counts, got page={page_words} / "
                    f"slot={wps} words")
            pb = pc = None
            if placed:
                bb, bp = tabs[paths.index(path)]
                pb_flat, pc_flat = arena.refine_tables(
                    bb.numpy(), bp.numpy(), page_words)
                n = n_layers * self.total_pages
                pb = pb_flat[:n].reshape(n_layers, self.total_pages)
                pc = pc_flat[:n].reshape(n_layers, self.total_pages)
            out.append(_PoolLeaf(
                path=path, container=m.group(1), slot_key=m.group(2),
                which=m.group(3), stacked=stacked, n_layers=n_layers,
                wps=wps, page_words=page_words,
                layer_words=self.total_pages * page_words, length=length,
                n_pages=length // self.page_slots, layout=layout,
                page_base=pb, page_pc=pc))
        return tuple(out)

    def _page_classes(self):
        """(weak, worst-rate) per usable page over every leaf/layer slice
        the page id provisions: weak when any K/V payload slice overlaps
        a weak DRAM row (``pos`` is not counted)."""
        weak = np.zeros(self.num_pages, bool)
        rate = np.zeros(self.num_pages, np.float64)
        if self.placement is None:
            return weak, rate
        fmap = self.faultmap
        wpc = fmap.geometry.bytes_per_pc // 4
        wpr = 1 << fmap.words_per_row_log2
        rates = fmap.predicted_rates(self.domain.voltage)
        rmasks = {int(pc): fmap.weak_row_mask(int(pc))
                  for pc in self.domain.pc_ids}
        for leaf in self.leaves:
            base = leaf.page_base[:, :self.num_pages].astype(np.int64)
            pc = leaf.page_pc[:, :self.num_pages]
            for l in range(leaf.n_layers):
                rate = np.maximum(rate, rates[pc[l]])
                if leaf.which not in ("k", "v"):
                    continue
                in_pc = base[l] - pc[l].astype(np.int64) * wpc
                r0 = in_pc // wpr
                r1 = (in_pc + leaf.page_words - 1) // wpr
                weak |= np.array([rmasks[int(c)][int(a):int(b) + 1].any()
                                  for c, a, b in zip(pc[l], r0, r1)])
        return weak, rate

    @property
    def uniform(self) -> bool:
        """True when every ring leaf is full-length: prefix sharing keys on
        page-aligned position prefixes, which line up only then."""
        return all(l.layout == "full" for l in self.leaves)

    # ---- allocation ------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._strong) + len(self._weak)

    @property
    def num_weak_pages(self) -> int:
        return len(self._weak_set)

    def alloc(self, n_pages: int, tier="cheap") -> np.ndarray:
        """Allocate ``n_pages`` page ids under ``tier``'s policy; raises
        CapacityError when the pool cannot supply them (for weak-avoiding
        tiers, weak pages do not count as supply)."""
        tier = resolve_tier(tier)
        name = self.domain.name if self.domain is not None else "page_pool"
        if tier.avoid_weak_rows:
            if len(self._strong) < n_pages:
                raise CapacityError(
                    name, n_pages * self.page_set_words * 4,
                    len(self._strong) * self.page_set_words * 4,
                    f"{n_pages} weak-free pages for tier {tier.name!r}; "
                    f"{len(self._weak)} weak pages held back",
                    shard=self.shard)
            taken = self._strong[:n_pages]
            del self._strong[:n_pages]
        else:
            if self.free_pages < n_pages:
                raise CapacityError(
                    name, n_pages * self.page_set_words * 4,
                    self.free_pages * self.page_set_words * 4,
                    f"{n_pages} pages for tier {tier.name!r}",
                    shard=self.shard)
            taken = self._weak[:n_pages]
            del self._weak[:n_pages]
            need = n_pages - len(taken)
            if need:
                taken += self._strong[-need:][::-1]
                del self._strong[-need:]
        self._owned.update(taken)
        return np.asarray(taken, np.int32)

    def free(self, page_ids) -> None:
        """Return pages to the pool (double free raises ValueError, a
        page with sharing holders raises PageSharingError)."""
        ids = [int(p) for p in np.asarray(page_ids).reshape(-1)]
        held = [p for p in ids if p in self._shared]
        if held:
            raise PageSharingError(
                f"free() of shared pages {sorted(held)[:4]}: pages with "
                "live holders must be released per holder, not freed")
        bad = [p for p in ids if p not in self._owned]
        if bad or len(set(ids)) != len(ids):
            raise ValueError(
                f"double free of pool pages {sorted(set(bad) or set(ids))[:4]}: "
                "not currently allocated")
        for p in ids:
            self._reinsert(p)

    def _reinsert(self, p: int) -> None:
        self._owned.discard(p)
        lst = self._weak if p in self._weak_set else self._strong
        keys = [(self._rate[q], q) for q in lst]
        lst.insert(bisect.bisect_left(keys, (self._rate[p], p)), p)

    def quarantine(self, page_ids) -> None:
        unported("page quarantine", 9, "self-healing")

    def migrate(self, src, dst) -> None:
        unported("page migration", 9, "self-healing")

    # ---- copy-on-write prefix sharing ------------------------------------
    @property
    def shared_pages(self) -> int:
        return len(self._shared)

    @property
    def prefix_entries(self) -> int:
        return len(self._prefix)

    def is_shared(self, pid) -> bool:
        return int(pid) in self._shared

    def share(self, page_ids, holder) -> None:
        """Turn privately owned pages into shared pages held by
        ``holder``."""
        for p in (int(q) for q in np.asarray(page_ids).reshape(-1)):
            if p not in self._owned:
                raise PageSharingError(
                    f"share of page {p}: not currently allocated")
            if p in self._shared:
                raise PageSharingError(
                    f"share of page {p}: already shared (holders="
                    f"{len(self._shared[p])}); use retain()")
            self._shared[p] = {holder}

    def retain(self, page_ids, holder) -> None:
        """Add ``holder`` to shared pages' holder sets."""
        pids = [int(q) for q in np.asarray(page_ids).reshape(-1)]
        for p in pids:
            if p not in self._shared:
                raise PageSharingError(
                    f"retain of page {p}: not a shared page")
            if holder in self._shared[p]:
                raise PageSharingError(
                    f"retain of page {p}: holder {holder!r} already holds it")
        for p in pids:
            self._shared[p].add(holder)

    def release(self, page_ids, holder) -> None:
        """Drop ``holder``'s reference; a page whose holder set empties
        returns to the free lists."""
        pids = [int(q) for q in np.asarray(page_ids).reshape(-1)]
        for p in pids:
            if p not in self._shared or holder not in self._shared[p]:
                raise PageSharingError(
                    f"double release of page {p} by holder {holder!r}: "
                    "not currently held")
        for p in pids:
            self._shared[p].discard(holder)
            if not self._shared[p]:
                del self._shared[p]
                self._reinsert(p)

    def cow_fork(self, src_pid, tier="cheap") -> int:
        """Allocate the private target page for copy-on-write forking the
        shared page ``src_pid``."""
        src = int(np.asarray(src_pid).reshape(()))
        if src not in self._shared:
            raise PageSharingError(
                f"cow_fork of page {src}: not a shared page (private pages "
                "are written in place, never forked)")
        return int(self.alloc(1, tier)[0])

    def match_prefix(self, tokens: np.ndarray) -> Tuple[int, np.ndarray]:
        """Longest cached prefix of ``tokens``: the full prompt first
        (partial boundary page -> COW fork), then page-aligned prefixes
        descending.  Returns (matched_len, shared page ids)."""
        toks = np.ascontiguousarray(tokens, np.int32).reshape(-1)
        n = toks.shape[0]
        lengths = [n] + [k * self.page_slots
                         for k in range(n // self.page_slots, 0, -1)
                         if k * self.page_slots != n]
        for ln in lengths:
            pids = self._prefix.get(toks[:ln].tobytes())
            if pids is not None:
                return ln, pids.copy()
        return 0, np.zeros((0,), np.int32)

    def register_prefix(self, tokens: np.ndarray, page_ids) -> bool:
        """Publish shared ``page_ids`` as the storage of the prompt prefix
        ``tokens`` (the cache entry holds them until evicted).  Returns
        False when the key is already cached."""
        toks = np.ascontiguousarray(tokens, np.int32).reshape(-1)
        key = toks.tobytes()
        if key in self._prefix:
            return False
        pids = np.asarray(page_ids, np.int32).reshape(-1)
        self.retain(pids, ("__prefix__", key))
        self._prefix[key] = pids.copy()
        return True

    def evict_prefix(self) -> bool:
        """Drop the least-recently-registered prefix entry, releasing its
        holds.  Returns False when the cache is empty."""
        if not self._prefix:
            return False
        key = next(iter(self._prefix))
        pids = self._prefix.pop(key)
        self.release(pids, ("__prefix__", key))
        if self.on_event is not None:
            self.on_event("prefix_evict", pages=len(pids))
        return True

    # ---- exports ---------------------------------------------------------
    def request_placement(self, page_ids) -> Optional[RequestPlacement]:
        """The page-granular placement of one request's standalone (B=1,
        contiguous) cache: logical page ``j`` of layer ``l`` lives where
        pool page ``page_ids[j]``'s layer-``l`` slice lives."""
        if self.placement is None:
            return None
        pids = np.asarray(page_ids, np.int64).reshape(-1)
        assert pids.shape[0] == self.n_logical_pages, pids.shape
        leaves = []
        for leaf in self.leaves:
            lp = pids[:leaf.n_pages]
            leaves.append(PagedLeafPlacement(
                path=leaf.path,
                n_words=leaf.n_layers * leaf.length * leaf.wps,
                page_words=leaf.page_words,
                page_base=np.ascontiguousarray(
                    leaf.page_base[:, lp].reshape(-1), np.uint32),
                page_pc=np.ascontiguousarray(
                    leaf.page_pc[:, lp].reshape(-1), np.int32)))
        return RequestPlacement(
            group="kv_cache", domain=self.domain, leaves=tuple(leaves),
            map_seed=(self.faultmap.seed
                      if self.faultmap is not None else None))


# ---------------------------------------------------------------------------
# Device-side paged cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _PagedLeafEntry:
    base: torch.Tensor         # (n_layers, total_pages) int32
    thr: torch.Tensor          # (n_layers, total_pages, NUM_THR_COLS) int32


@dataclasses.dataclass(frozen=True)
class _PagedSlotEntry:
    k: _PagedLeafEntry
    v: _PagedLeafEntry
    length: int = 0            # this ring's logical length
    n_pages: int = 0           # leading page-table entries it addresses


@dataclasses.dataclass
class PagedServingCtx:
    """Decode-step hook for the paged serving cache: the pool-page write
    and attention through K4.  Inactive serving slots' page-table rows
    point at the scratch page; their lanes compute masked garbage that
    the scheduler discards."""

    entries: Dict[str, _PagedSlotEntry]
    page_table: torch.Tensor   # (S, n_logical_pages) int32 on the device
    length: int                # logical ring length (max_len)
    page_slots: int
    seed: int
    words_per_row_log2: int
    method: str
    ecc: bool
    inject: bool

    def covers(self, slot_key: str) -> bool:
        return slot_key in self.entries

    def update(self, slot_key: str, cache, new, pos):
        e = self.entries[slot_key]
        return C.paged_update(cache, new, pos,
                              self.page_table[:, :e.n_pages], e.length,
                              self.page_slots)

    def attend(self, slot_key: str, layer_idx, q, cache, *, q_pos,
               causal: bool, window: int, scale=None):
        e = self.entries[slot_key]
        idx = 0 if layer_idx is None else int(layer_idx)
        qp = torch.as_tensor(q_pos).reshape(q.shape[0], -1)[:, 0]
        return faulty.paged_decode_attention(
            q.contiguous(), cache["k"], cache["v"], cache["pos"],
            self.page_table[:, :e.n_pages],
            q_pos=torch.clamp_min(qp, 0).to(torch.int32),
            k_tables=(e.k.base[idx], e.k.thr[idx]),
            v_tables=(e.v.base[idx], e.v.thr[idx]), causal=causal,
            window=window, scale=scale, seed=self.seed, method=self.method,
            words_per_row_log2=self.words_per_row_log2, ecc=self.ecc,
            inject=self.inject)


@dataclasses.dataclass
class MixedServingCtx(PagedServingCtx):
    """Mixed prefill-chunk / decode step hook.

    Decode lanes (column 0 of a decoding slot) attend through K4 exactly
    as :class:`PagedServingCtx` does.  Each prefilling slot's chunk
    attends cleanly over its whole ring gathered from its pages, with
    arithmetic key positions (the stored ``pos`` of a shared page carries
    its creator's write-path faults) and keys valid below
    ``prefill_end``, through :func:`repro_torch.models.layers.
    ring_attention` -- the computation exact prefill makes over the same
    ring, row for row.  Writes below ``wstart`` (rows of copy-on-write
    shared pages) go to the scratch page."""

    wstart: Optional[torch.Tensor] = None     # (S,) int32 on the device
    prefill_end: Sequence[int] = ()           # per prefilling slot (host)
    prefill_slots: Sequence[int] = ()         # slots prefilling this step
    scratch_id: int = 0

    def update(self, slot_key: str, cache, new, pos):
        e = self.entries[slot_key]
        if e.length < self.length:
            unported("chunked prefill over a sliding-window ring", 12,
                      "model-zoo")
        return C.paged_update(cache, new, pos,
                              self.page_table[:, :e.n_pages], e.length,
                              self.page_slots, wstart=self.wstart,
                              scratch_id=self.scratch_id)

    def attend(self, slot_key: str, layer_idx, q, cache, *, q_pos,
               causal: bool, window: int, scale=None):
        s, c = q.shape[:2]
        qp = torch.as_tensor(q_pos).reshape(s, -1).expand(s, c)
        dec = PagedServingCtx.attend(self, slot_key, layer_idx, q[:, :1],
                                     cache, q_pos=qp[:, 0], causal=causal,
                                     window=window, scale=scale)
        if not self.prefill_slots:
            return dec if c == 1 else torch.cat(
                [dec, dec.new_zeros((s, c - 1) + dec.shape[2:])], dim=1)
        out = dec.new_zeros(q.shape[:3] + (cache["v"].shape[-1],))
        out[:, :1] = dec
        kpos = torch.arange(self.length, dtype=torch.int32,
                            device=q.device)[None]
        for g, end in zip(self.prefill_slots, self.prefill_end):
            pids = self.page_table[g].long()
            ring_k = cache["k"][pids].reshape((1, self.length)
                                              + cache["k"].shape[2:])
            ring_v = cache["v"][pids].reshape((1, self.length)
                                              + cache["v"].shape[2:])
            out[g:g + 1] = L.ring_attention(
                q[g:g + 1], ring_k, ring_v, q_positions=qp[g:g + 1],
                k_positions=kpos, kv_valid=kpos < int(end), causal=causal,
                window=window, softmax_scale=scale)
        return out


class PagedKVCache:
    """Device-side data paths of one :class:`PagePool`, in place on the
    pool tree: init, admission reset / fork, transition injection, the
    per-step write-path injection and the decode-step context."""

    def __init__(self, pool: PagePool, device):
        self.pool = pool
        self.device = torch.device(device)
        self._ctx_tables: Dict[Optional[float],
                               Dict[str, _PagedSlotEntry]] = {}
        self._write_tables: Dict[Tuple[str, float], Tuple] = {}
        self._block_tables = {}
        if pool.placement is not None:
            paths = [lp.path for lp in pool.placement.leaves]
            tabs = arena.leaf_block_tables(pool.placement)
            for leaf in pool.leaves:
                bb, bp = tabs[paths.index(leaf.path)]
                self._block_tables[leaf.path] = (bb.to(self.device), bp)

    def init_pool(self):
        return C.init_cache(self.pool.pool_specs, self.device)

    @staticmethod
    def _leaf_arrays(tree, leaf: _PoolLeaf):
        arr = tree[leaf.container][leaf.slot_key][leaf.which]
        return arr if leaf.stacked else arr[None]

    def _thr(self, leaf: _PoolLeaf, voltage: float):
        """(block_base, block_thr) device tables of the leaf at
        ``voltage``, copied to the device once."""
        key = (leaf.path, float(voltage))
        got = self._write_tables.get(key)
        if got is None:
            bb, bp = self._block_tables[leaf.path]
            table = self.pool.faultmap.threshold_table(float(voltage))
            got = (bb, table[bp].to(self.device))
            self._write_tables[key] = got
        return got

    # ---- context ---------------------------------------------------------
    def _entries(self, voltage: Optional[float]):
        p = self.pool
        key = None if p.placement is None else float(voltage)
        got = self._ctx_tables.get(key)
        if got is not None:
            return got
        halves: Dict[str, Dict[str, _PagedLeafEntry]] = {}
        geom: Dict[str, Tuple[int, int]] = {}
        table = (p.faultmap.threshold_table(key) if key is not None
                 else None)
        for leaf in p.leaves:
            if leaf.which not in ("k", "v"):
                continue
            geom[leaf.slot_key] = (leaf.length, leaf.n_pages)
            if table is not None:
                base = H.as_i32(torch.from_numpy(
                    leaf.page_base.astype(np.int64)))
                thr = table[torch.from_numpy(leaf.page_pc.astype(np.int64))]
            else:
                base = torch.zeros((leaf.n_layers, p.total_pages),
                                   dtype=torch.int32)
                thr = torch.zeros((leaf.n_layers, p.total_pages,
                                   NUM_THR_COLS), dtype=torch.int32)
            halves.setdefault(leaf.slot_key, {})[leaf.which] = \
                _PagedLeafEntry(base=base.to(self.device).contiguous(),
                                thr=thr.to(self.device).contiguous())
        entries = {k: _PagedSlotEntry(k=h["k"], v=h["v"], length=geom[k][0],
                                      n_pages=geom[k][1])
                   for k, h in halves.items()}
        self._ctx_tables[key] = entries
        return entries

    def make_ctx(self, page_table, voltage, *, method: str, inject: bool,
                 wstart=None, prefill_slots=None, prefill_end=None,
                 chaos=None) -> PagedServingCtx:
        """Decode-step context; passing ``wstart`` (and the prefilling
        slots with their ``prefill_end``) returns the mixed
        chunked-prefill/decode variant."""
        if chaos is not None:
            unported("the chaos (row-goes-weak) hook", 9, "self-healing")
        p = self.pool
        if p.placement is not None:
            seed, wprl2 = p.faultmap.seed, p.faultmap.words_per_row_log2
            ecc = p.domain.ecc
        else:
            seed, wprl2, ecc, inject = 0, 0, False, False
        kw = dict(entries=self._entries(voltage), page_table=page_table,
                  length=p.max_len, page_slots=p.page_slots, seed=seed,
                  words_per_row_log2=wprl2, method=method, ecc=ecc,
                  inject=inject)
        if wstart is not None:
            return MixedServingCtx(
                wstart=wstart, prefill_slots=tuple(prefill_slots or ()),
                prefill_end=tuple(prefill_end or ()),
                scratch_id=p.scratch_id, **kw)
        return PagedServingCtx(**kw)

    def scrub_telemetry(self, *args, **kwargs):
        unported("the telemetry scrub", 9, "self-healing")

    def migrate_pages(self, *args, **kwargs):
        unported("in-step page migration", 9, "self-healing")

    # ---- admission -------------------------------------------------------
    def scatter_request(self, tree, cache, page_ids):
        """Write a standalone (B=1) cache into the pages ``page_ids``, in
        place: the pages then hold exactly that request's state."""
        pids = torch.as_tensor(np.asarray(page_ids, np.int64),
                               device=self.device)
        for leaf in self.pool.leaves:
            arr_l = self._leaf_arrays(tree, leaf)
            src = self._leaf_arrays(cache, leaf)              # (nl, 1, L, ..)
            src = src.reshape((leaf.n_layers, leaf.n_pages,
                               self.pool.page_slots) + tuple(src.shape[3:]))
            arr_l[:, pids[:leaf.n_pages]] = src.to(arr_l.dtype)
        return tree

    def reset_and_fork(self, tree, page_ids, fork_src: int, fork_dst: int,
                       fork_rows: int, fork_pos0: int):
        """Chunked-prefill admission, in place: reset ``page_ids`` to the
        init state (pos -1, values 0), then copy-on-write fork the shared
        boundary page ``fork_src`` into the private page ``fork_dst``:
        rows below ``fork_rows`` copy its (clean) K/V with positions
        ``fork_pos0 + row`` (a shared page's stored ``pos`` carries its
        creator's write-path faults and is never copied), the rest reset.
        A disabled fork points both pages at scratch."""
        p = self.pool
        pids = torch.as_tensor(np.asarray(page_ids, np.int64),
                               device=self.device)
        rows = torch.arange(p.page_slots, device=self.device)
        keep = rows < int(fork_rows)
        for leaf in p.leaves:
            arr_l = self._leaf_arrays(tree, leaf)
            if leaf.which == "pos":
                arr_l[:, pids] = -1
                fork = torch.where(keep, int(fork_pos0) + rows, -1).to(
                    arr_l.dtype).expand(leaf.n_layers, p.page_slots)
            else:
                arr_l[:, pids] = 0
                srcv = arr_l[:, int(fork_src)]             # (nl, ps, ...)
                mask = keep.reshape((1, p.page_slots)
                                    + (1,) * (srcv.dim() - 2))
                fork = torch.where(mask, srcv, torch.zeros_like(srcv))
            arr_l[:, int(fork_dst)] = fork
        return tree

    def inject_pages(self, tree, page_ids, voltage, *, method: str,
                     skip_kv: bool):
        """Whole-page write-path injection of one request's pages, in
        place -- the paged twin of the engine's post-prefill
        ``init_inject`` (same physical words, same masks).  ``skip_kv``:
        only the ``pos`` bookkeeping is corrupted (read mode, and pages
        that are shared)."""
        p = self.pool
        ids = [int(q) for q in np.asarray(page_ids).reshape(-1)
               if int(q) != p.scratch_id]
        if p.placement is None or not ids:
            return tree
        pids = torch.as_tensor(ids, dtype=torch.int64, device=self.device)
        n = len(ids)
        for leaf in p.leaves:
            if skip_kv and leaf.which in ("k", "v"):
                continue
            bb, bt = self._thr(leaf, voltage)
            arr_l = self._leaf_arrays(tree, leaf)
            vals = arr_l[:, pids]                       # (nl, n, ps, ...)
            u32 = faulty._tile_to_u32(
                vals.reshape(leaf.n_layers * n, -1)).reshape(
                    leaf.n_layers, n, leaf.page_words)
            off = (torch.arange(leaf.n_layers, dtype=torch.int64,
                                device=self.device)[:, None, None]
                   * leaf.layer_words + pids[None, :, None] * leaf.page_words
                   + torch.arange(leaf.page_words, dtype=torch.int64,
                                  device=self.device))
            out, _ = arena.corrupt_words(
                u32, off, bb, bt, seed=p.faultmap.seed, method=method,
                words_per_row_log2=p.faultmap.words_per_row_log2,
                ecc=p.domain.ecc)
            arr_l[:, pids] = faulty._tile_from_u32(out, vals.dtype,
                                                   vals.shape)
        return tree

    # ---- per-step write path ---------------------------------------------
    def post_step_inject(self, tree, page_table, q_pos, voltage, *,
                         mode: str, method: str):
        """Write-path injection of exactly the words a decode step wrote,
        in place: the (page, row) slot of each given serving slot in every
        layer.  ``page_table`` (S', n_lp) and ``q_pos`` (S',) hold the
        decoding slots only.  In read mode only the ``pos`` bookkeeping is
        covered; ECC domains corrupt the whole ``pos`` pages (a single
        position splits a codeword), like the standalone engine."""
        p = self.pool
        if p.placement is None or page_table.shape[0] == 0:
            return tree
        kw = dict(seed=p.faultmap.seed, method=method,
                  words_per_row_log2=p.faultmap.words_per_row_log2)
        qp = q_pos.reshape(-1).long()
        ns = qp.shape[0]
        ptab = page_table.long()
        dev = self.device
        for leaf in p.leaves:
            if mode == "read" and leaf.which in ("k", "v"):
                continue
            slot = qp % leaf.length
            lp = slot // p.page_slots
            row = slot % p.page_slots
            pid = torch.gather(ptab, 1, lp[:, None])[:, 0]
            bb, bt = self._thr(leaf, voltage)
            arr_l = self._leaf_arrays(tree, leaf)
            layer = torch.arange(leaf.n_layers, dtype=torch.int64,
                                 device=dev)
            if leaf.which == "pos" and p.domain.ecc:
                ptab_l = ptab[:, :leaf.n_pages]
                vals = arr_l[:, ptab_l]                 # (nl, S', n_lp, ps)
                off = (layer[:, None, None, None] * leaf.layer_words
                       + ptab_l[None, :, :, None] * leaf.page_words
                       + torch.arange(p.page_slots, dtype=torch.int64,
                                      device=dev))
                out, _ = arena.corrupt_words(vals, off, bb, bt, ecc=True,
                                             **kw)
                arr_l[:, ptab_l] = out
                continue
            vals = arr_l[:, pid, row]                   # (nl, S', ...)
            u32 = faulty._tile_to_u32(
                vals.reshape(leaf.n_layers * ns, -1)).reshape(
                    leaf.n_layers, ns, leaf.wps)
            off = (layer[:, None, None] * leaf.layer_words
                   + ((pid * p.page_slots + row) * leaf.wps)[None, :, None]
                   + torch.arange(leaf.wps, dtype=torch.int64, device=dev))
            out, _ = arena.corrupt_words(u32, off, bb, bt,
                                         ecc=p.domain.ecc, **kw)
            arr_l[:, pid, row] = faulty._tile_from_u32(out, vals.dtype,
                                                       vals.shape)
        return tree
