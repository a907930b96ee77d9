"""Memory domains and physical placement (port of :mod:`repro.core.domains`).

A :class:`MemoryDomain` is a named (voltage, PC subset, ECC flag) region;
:func:`place_groups` allocates every leaf of every tensor group into its
domain's PCs at 16 KiB (4096-word) granularity, producing the physical
segments the injection engine addresses.  Leaves are placed in
keystr-sorted order, exactly like the reference, so both packages give
every word the same physical address.

Criticality tiers (:data:`TIERS`) route the paged serving pool's page
allocation and :func:`place_groups_tiered`, which hands PCs out
most-reliable-first and may skip blocks holding weak rows.  The
allocator recycles freed blocks in reliability order, and the
self-healing scheduler retires drained blocks through an allocator that
adopted the pool's placement (``adopt``, ``register_pool``,
``quarantine``).
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import weakref
from typing import Dict, List, Optional, Tuple

from repro_torch.core import pytree
from repro_torch.core.faultmodel import V_CRITICAL, V_NOM
from repro_torch.core.hbm import HBMGeometry

ALIGN_WORDS = 4096


class DeviceCrashError(RuntimeError):
    """A domain driven below V_critical: the part stops responding."""


class CapacityError(MemoryError):
    """Allocation overflow: names the domain, the request and what is left."""

    def __init__(self, domain: str, requested_bytes: int, free_bytes: int,
                 note: str = "", shard=None):
        self.domain = domain
        self.requested_bytes = int(requested_bytes)
        self.free_bytes = int(free_bytes)
        self.shard = shard
        msg = (f"domain {domain!r} out of capacity: requested "
               f"{self.requested_bytes} B, remaining extent "
               f"{self.free_bytes} B")
        if shard is not None:
            msg += f" on shard {shard}"
        if note:
            msg += f" ({note})"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class CriticalityTier:
    """A tensor group's declared fault tolerance.

    ``max_rate`` is the tolerable total stuck-cell rate of the extent the
    group occupies; ``max_rate <= 0`` means "fault-free in expectation"
    (< 1 expected faulty bit per PC).  ``avoid_weak_rows`` additionally
    keeps the group off extents that hold weak rows."""

    name: str
    max_rate: float
    avoid_weak_rows: bool = False

    def admits(self, rate: float, bits_per_pc: int) -> bool:
        if self.max_rate <= 0.0:
            return rate * bits_per_pc < 1.0
        return rate <= self.max_rate


# The tier ladder, strictest first.  ``shared_prefix`` is the serving
# pool's tier for copy-on-write shared prompt pages: one corrupted shared
# page poisons every tenant that maps it.
TIERS: Dict[str, CriticalityTier] = {
    t.name: t for t in (
        CriticalityTier("shared_prefix", 0.0, avoid_weak_rows=True),
        CriticalityTier("critical", 0.0, avoid_weak_rows=True),
        CriticalityTier("safe", 0.0),
        CriticalityTier("hedged", 1e-6, avoid_weak_rows=True),
        CriticalityTier("cheap", 1e-3),
        CriticalityTier("disposable", 0.5),
    )
}


def resolve_tier(tier) -> CriticalityTier:
    if isinstance(tier, CriticalityTier):
        return tier
    if isinstance(tier, str):
        try:
            return TIERS[tier]
        except KeyError:
            raise ValueError(
                f"unknown criticality tier {tier!r}; known: "
                f"{sorted(TIERS)}") from None
    raise TypeError(f"tier must be a name or CriticalityTier, got {tier!r}")


@dataclasses.dataclass(frozen=True)
class MemoryDomain:
    """A voltage/PC-subset region of one device's HBM."""

    name: str
    voltage: float
    pc_ids: Tuple[int, ...]
    ecc: bool = False

    def capacity_bytes(self, geometry: HBMGeometry) -> int:
        return len(self.pc_ids) * geometry.bytes_per_pc

    def validate(self, geometry: HBMGeometry) -> None:
        if not self.pc_ids:
            raise ValueError(f"domain {self.name!r} has no PCs")
        if len(set(self.pc_ids)) != len(self.pc_ids):
            raise ValueError(f"domain {self.name!r} repeats PCs")
        for pc in self.pc_ids:
            if not 0 <= pc < geometry.num_pcs:
                raise ValueError(f"domain {self.name!r}: pc {pc} out of range")
        if self.voltage > V_NOM + 1e-9:
            raise ValueError(f"domain {self.name!r}: overvolting not modeled")
        if self.voltage < V_CRITICAL - 1e-9:
            raise DeviceCrashError(
                f"domain {self.name!r} at {self.voltage:.2f} V is below "
                f"V_critical={V_CRITICAL} V: HBM stops responding and "
                "requires a power cycle")


@dataclasses.dataclass(frozen=True)
class Segment:
    """A contiguous physical run backing part of one leaf."""

    leaf_start_word: int
    n_words: int
    pc: int
    phys_base_word: int


@dataclasses.dataclass(frozen=True)
class LeafPlacement:
    path: str
    n_words: int
    segments: Tuple[Segment, ...]


@dataclasses.dataclass(frozen=True)
class BlockTable:
    """Flat block-indexed export of a :class:`GroupPlacement`:
    ``block_pc[i]`` / ``block_base[i]`` describe arena block ``i`` and
    ``leaf_blocks`` holds each leaf's ``(start_block, n_blocks, n_words)``
    in placement order."""

    block_pc: Tuple[int, ...]
    block_base: Tuple[int, ...]
    leaf_blocks: Tuple[Tuple[int, int, int], ...]

    @property
    def num_blocks(self) -> int:
        return len(self.block_pc)


@functools.lru_cache(maxsize=256)
def _block_table(placement: "GroupPlacement") -> BlockTable:
    block_pc: List[int] = []
    block_base: List[int] = []
    leaf_blocks: List[Tuple[int, int, int]] = []
    for leaf in placement.leaves:
        start_block = len(block_pc)
        for si, seg in enumerate(leaf.segments):
            assert seg.leaf_start_word % ALIGN_WORDS == 0
            assert seg.phys_base_word % ALIGN_WORDS == 0
            assert (si == len(leaf.segments) - 1
                    or seg.n_words % ALIGN_WORDS == 0)
            for b in range(-(-seg.n_words // ALIGN_WORDS)):
                block_pc.append(seg.pc)
                block_base.append(seg.phys_base_word + b * ALIGN_WORDS)
        leaf_blocks.append((start_block, len(block_pc) - start_block,
                            leaf.n_words))
    return BlockTable(block_pc=tuple(block_pc), block_base=tuple(block_base),
                      leaf_blocks=tuple(leaf_blocks))


@dataclasses.dataclass(frozen=True)
class GroupPlacement:
    group: str
    domain: MemoryDomain
    leaves: Tuple[LeafPlacement, ...]

    @property
    def total_words(self) -> int:
        return sum(lp.n_words for lp in self.leaves)

    def block_table(self) -> BlockTable:
        return _block_table(self)


def leaf_words(leaf) -> int:
    """uint32 words a leaf occupies (anything with ``shape``/``dtype``)."""
    size = 1
    for d in leaf.shape:
        size *= d
    return (size * leaf.dtype.itemsize + 3) // 4


class DomainAllocator:
    """Block-granular bump allocator over a domain's pseudo-channels.

    Without a fault map: PCs in the domain's declared order, every block
    eligible.  With one, PCs are handed out most-reliable-first (at the
    domain's voltage), and an allocation may ask for *weak-row
    avoidance*: blocks holding weak rows are skipped and kept as spares
    for later allocations that do not avoid them, so avoidance costs no
    capacity overall.  After a :class:`CapacityError` the allocator state
    is undefined; the placement must be rebuilt from scratch.

    :meth:`free` returns blocks for recycling in reliability order, ahead
    of the bump cursor, so a free-then-realloc of the same footprint lands
    on the same blocks; :meth:`quarantine` retires blocks for good."""

    def __init__(self, geometry: HBMGeometry, domain: MemoryDomain,
                 faultmap=None):
        domain.validate(geometry)
        self.geometry = geometry
        self.domain = domain
        self.faultmap = faultmap
        self.words_per_pc = geometry.bytes_per_pc // 4
        assert self.words_per_pc % ALIGN_WORDS == 0, "PC must be block-aligned"
        self.blocks_per_pc = self.words_per_pc // ALIGN_WORDS
        if faultmap is not None:
            rank = {int(pc): i for i, pc in
                    enumerate(faultmap.reliability_order(domain.voltage))}
            self.pc_order: Tuple[int, ...] = tuple(sorted(
                domain.pc_ids, key=lambda pc: rank[int(pc)]))
        else:
            self.pc_order = tuple(domain.pc_ids)
        self._rank = {pc: i for i, pc in enumerate(self.pc_order)}
        self._total_blocks = len(self.pc_order) * self.blocks_per_pc
        self._cursor = 0                 # blocks handed past, in pc_order
        self._spares: List[Tuple[int, int]] = []   # skipped weak blocks
        self._freed: List[Tuple[int, int, int]] = []  # (rank, blk, pc)
        self._owned: set = set()         # (pc, blk) currently allocated
        self._free_blocks = self._total_blocks
        self._weak_cache: Dict[int, object] = {}
        self._quarantined: set = set()   # (pc, blk) retired for good
        self._pools: List[object] = []   # live-page guards (weakrefs)

    @property
    def free_words(self) -> int:
        return self._free_blocks * ALIGN_WORDS

    def _block_at(self, i: int) -> Tuple[int, int]:
        return self.pc_order[i // self.blocks_per_pc], i % self.blocks_per_pc

    def _is_weak(self, pc: int, block: int) -> bool:
        if self.faultmap is None:
            return False
        mask = self._weak_cache.get(pc)
        if mask is None:
            mask = self.faultmap.weak_block_mask(pc, ALIGN_WORDS)
            self._weak_cache[pc] = mask
        return bool(mask[block])

    def _take(self, n_blocks: int, avoid_weak_rows: bool):
        """The next ``n_blocks`` (pc, block) pairs under the avoidance
        policy with the post-take cursor, spares and freed list, or None
        if the domain cannot supply them.  Freed blocks (in reliability
        order) are recycled before the cursor advances."""
        cursor, spares = self._cursor, list(self._spares)
        freed = list(self._freed)
        taken: List[Tuple[int, int]] = []
        if avoid_weak_rows:
            i = 0
            while i < len(freed) and len(taken) < n_blocks:
                _, blk, pc = freed[i]
                if self._is_weak(pc, blk):
                    i += 1
                    continue
                taken.append((pc, blk))
                freed.pop(i)
        else:
            while freed and len(taken) < n_blocks:
                _, blk, pc = freed.pop(0)
                taken.append((pc, blk))
            while spares and len(taken) < n_blocks:
                taken.append(spares.pop(0))
        while len(taken) < n_blocks and cursor < self._total_blocks:
            pc, blk = self._block_at(cursor)
            cursor += 1
            if (pc, blk) in self._quarantined:
                continue                 # retired: never re-issued
            if avoid_weak_rows and self._is_weak(pc, blk):
                spares.append((pc, blk))
                continue
            taken.append((pc, blk))
        if len(taken) < n_blocks:
            return None
        return taken, cursor, spares, freed

    def peek_pcs(self, n_words: int,
                 avoid_weak_rows: bool = False) -> Optional[Tuple[int, ...]]:
        """PCs the next ``n_words`` allocation would occupy (no commit),
        or None if it cannot be satisfied."""
        got = self._take(-(-n_words // ALIGN_WORDS), avoid_weak_rows)
        if got is None:
            return None
        return tuple(sorted({pc for pc, _ in got[0]}))

    def alloc(self, n_words: int,
              avoid_weak_rows: bool = False) -> Tuple[Segment, ...]:
        n_blocks = -(-n_words // ALIGN_WORDS)
        got = self._take(n_blocks, avoid_weak_rows)
        if got is None:
            note = (f"{len(self.domain.pc_ids)} PCs x "
                    f"{self.geometry.bytes_per_pc} B")
            if avoid_weak_rows:
                note += "; weak-row-avoiding allocation"
            raise CapacityError(self.domain.name, n_blocks * ALIGN_WORDS * 4,
                                self.free_words * 4, note)
        taken, self._cursor, self._spares, self._freed = got
        self._owned.update(taken)
        self._free_blocks -= n_blocks
        segments: List[Segment] = []
        for i, (pc, blk) in enumerate(taken):
            base = pc * self.words_per_pc + blk * ALIGN_WORDS
            words = min(ALIGN_WORDS, n_words - i * ALIGN_WORDS)
            prev = segments[-1] if segments else None
            if (prev is not None and prev.pc == pc
                    and prev.phys_base_word + prev.n_words == base):
                segments[-1] = dataclasses.replace(
                    prev, n_words=prev.n_words + words)
            else:
                segments.append(Segment(
                    leaf_start_word=i * ALIGN_WORDS, n_words=words, pc=pc,
                    phys_base_word=base))
        return tuple(segments)


    def _segment_blocks(self, segments) -> List[Tuple[int, int]]:
        """Validated (pc, block) pairs backing ``segments``."""
        blocks: List[Tuple[int, int]] = []
        for seg in segments:
            if seg.pc not in self._rank:
                raise ValueError(
                    f"segment pc {seg.pc} not in domain "
                    f"{self.domain.name!r} (PCs {sorted(self._rank)})")
            rel = seg.phys_base_word - seg.pc * self.words_per_pc
            if rel % ALIGN_WORDS or not 0 <= rel < self.words_per_pc:
                raise ValueError(
                    f"segment base {seg.phys_base_word} is not a block "
                    f"of pc {seg.pc} in domain {self.domain.name!r}")
            blk0 = rel // ALIGN_WORDS
            for b in range(blk0, blk0 + -(-seg.n_words // ALIGN_WORDS)):
                blocks.append((seg.pc, b))
        return blocks

    def _check_owned(self, blocks: List[Tuple[int, int]], verb: str):
        dup = sorted(set(b for b in blocks if b not in self._owned))
        if len(set(blocks)) != len(blocks):
            dup = sorted(set(b for b in blocks if blocks.count(b) > 1))
        if dup:
            raise ValueError(
                f"double {verb} in domain {self.domain.name!r}: "
                f"(pc, block) {dup[:4]} not currently allocated "
                "(freed twice, or never handed out by this allocator)")

    def register_pool(self, pool) -> None:
        """Attach a :class:`~repro_torch.serving.paged.PagePool` whose live
        pages guard :meth:`free` and :meth:`quarantine`: a block still
        backing a live page would alias two tenants onto one block."""
        self._pools.append(weakref.ref(pool))

    def _live_guard(self, blocks: List[Tuple[int, int]], verb: str):
        for ref in self._pools:
            pool = ref()
            if pool is None:
                continue
            live = pool.live_among(blocks)
            if live:
                raise ValueError(
                    f"cannot {verb} (pc, block) {sorted(live)[:4]} in "
                    f"domain {self.domain.name!r}: still backing live "
                    "pages of a registered PagePool (retire or migrate "
                    "the pages first, or two tenants would alias one "
                    "physical block)")

    def free(self, segments: Tuple[Segment, ...]) -> None:
        """Return the blocks backing ``segments`` to the allocator, in
        reliability order.  A double free, a foreign segment, a block
        outside the domain or one still backing live pages of a
        registered pool raises ValueError before any state changes."""
        blocks = self._segment_blocks(segments)
        self._check_owned(blocks, "free")
        self._live_guard(blocks, "free")
        for pc, blk in blocks:
            self._owned.discard((pc, blk))
            bisect.insort(self._freed, (self._rank[pc], blk, pc))
            self._free_blocks += 1

    def quarantine(self, segments: Tuple[Segment, ...]) -> None:
        """Retire the blocks backing ``segments`` for good: out of the
        owned set and never recycled (same guards as :meth:`free`)."""
        blocks = self._segment_blocks(segments)
        self._check_owned(blocks, "quarantine")
        self._live_guard(blocks, "quarantine")
        for pc, blk in blocks:
            self._owned.discard((pc, blk))
            self._quarantined.add((pc, blk))

    @property
    def quarantined_blocks(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(sorted(self._quarantined))

    def adopt(self, placement: "GroupPlacement") -> None:
        """Take ownership of an existing placement's blocks (valid on a
        fresh allocator only): they become owned, every other block of
        the domain is recycling-eligible in reliability order, and the
        cursor is exhausted, as if this allocator had handed the
        placement out itself."""
        if self._owned or self._cursor or self._freed or self._spares:
            raise ValueError("adopt() requires a fresh allocator")
        blocks: List[Tuple[int, int]] = []
        for leaf in placement.leaves:
            blocks.extend(self._segment_blocks(leaf.segments))
        owned = set(blocks)
        if len(owned) != len(blocks):
            raise ValueError("placement maps one block twice")
        self._owned = owned
        for i in range(self._total_blocks):
            pc, blk = self._block_at(i)
            if (pc, blk) not in owned:
                bisect.insort(self._freed, (self._rank[pc], blk, pc))
        self._cursor = self._total_blocks
        self._free_blocks = self._total_blocks - len(owned)


def sorted_leaves(tree):
    """(keystr path, leaf) pairs sorted by path string, as the reference
    sorts ``jax.tree_util.keystr`` paths."""
    flat = pytree.flatten_with_path(tree)
    return sorted(((pytree.keystr(p), leaf) for p, leaf in flat),
                  key=lambda kv: kv[0])


def place_groups(
    groups: Dict[str, object],           # group name -> tree of tensors/avals
    policy: Dict[str, str],              # group name -> domain name
    domains: Dict[str, MemoryDomain],
    geometry: HBMGeometry,
) -> Dict[str, GroupPlacement]:
    """Assign every leaf of every group a physical placement."""
    allocators = {name: DomainAllocator(geometry, d)
                  for name, d in domains.items()}
    out: Dict[str, GroupPlacement] = {}
    for group_name in sorted(groups):
        domain_name = policy[group_name]
        alloc = allocators[domain_name]
        leaves = []
        for path, leaf in sorted_leaves(groups[group_name]):
            n_words = leaf_words(leaf)
            leaves.append(LeafPlacement(path=path, n_words=n_words,
                                        segments=alloc.alloc(n_words)))
        out[group_name] = GroupPlacement(
            group=group_name, domain=domains[domain_name],
            leaves=tuple(leaves))
    return out


def place_groups_tiered(
    groups: Dict[str, object],           # group name -> tree of tensors/avals
    tiers: Dict[str, object],            # group name -> tier name or object
    domains: Dict[str, MemoryDomain],
    geometry: HBMGeometry,
    faultmap,
) -> Dict[str, GroupPlacement]:
    """Criticality-aware placement: route each group to the most
    power-saving domain whose predicted rate meets the group's tier.

    Domains are tried deepest-voltage-first; a domain admits a group when
    it has room for the group's block-aligned footprint under the tier's
    weak-row policy and the predicted stuck-cell rate of the exact PCs
    the group would occupy (the strong-row rate when the tier avoids weak
    rows) meets ``tier.max_rate``.  Groups are placed strictest tier
    first, so the most reliable PCs go to the least fault-tolerant data.
    Raises :class:`CapacityError` when no domain admits a group."""
    resolved = {g: resolve_tier(tiers[g]) for g in groups}
    allocators = {name: DomainAllocator(geometry, d, faultmap=faultmap)
                  for name, d in domains.items()}
    dom_order = sorted(domains.values(), key=lambda d: (d.voltage, d.name))
    out: Dict[str, GroupPlacement] = {}
    for group_name in sorted(groups,
                             key=lambda g: (resolved[g].max_rate, g)):
        tier = resolved[group_name]
        leaf_list = sorted_leaves(groups[group_name])
        footprint = sum(-(-leaf_words(leaf) // ALIGN_WORDS) * ALIGN_WORDS
                        for _, leaf in leaf_list)
        placed = None
        for d in dom_order:
            alloc = allocators[d.name]
            pcs = alloc.peek_pcs(footprint, tier.avoid_weak_rows)
            if pcs is None:
                continue                     # no capacity in this domain
            rates = faultmap.predicted_rates(d.voltage,
                                             tier.avoid_weak_rows)
            worst = float(max(rates[pc] for pc in pcs))
            if not tier.admits(worst, geometry.bits_per_pc):
                continue                     # too unreliable for the tier
            leaves = tuple(
                LeafPlacement(path=path, n_words=leaf_words(leaf),
                              segments=alloc.alloc(
                                  leaf_words(leaf),
                                  avoid_weak_rows=tier.avoid_weak_rows))
                for path, leaf in leaf_list)
            placed = GroupPlacement(group=group_name, domain=d,
                                    leaves=leaves)
            break
        if placed is None:
            free = max((allocators[d.name].free_words * 4
                        for d in dom_order), default=0)
            raise CapacityError(
                "|".join(d.name for d in dom_order), footprint * 4, free,
                f"no domain admits group {group_name!r} at tier "
                f"{tier.name!r} (max_rate={tier.max_rate:g}, "
                f"avoid_weak_rows={tier.avoid_weak_rows})")
        out[group_name] = placed
    return out
