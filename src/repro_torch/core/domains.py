"""Memory domains and physical placement (port of :mod:`repro.core.domains`).

A :class:`MemoryDomain` is a named (voltage, PC subset, ECC flag) region;
:func:`place_groups` allocates every leaf of every tensor group into its
domain's PCs at 16 KiB (4096-word) granularity, producing the physical
segments the injection engine addresses.  Leaves are placed in
keystr-sorted order, exactly like the reference, so both packages give
every word the same physical address.

The placement path runs without a fault map (``DomainAllocator.alloc``
in declared PC order).  Criticality tiers (:data:`TIERS`) route the
paged serving pool's page allocation; tiered placement
(``place_groups_tiered``) and the allocator's ``free``, ``quarantine``
and ``adopt`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

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
    """Block-granular bump allocator over a domain's pseudo-channels,
    in the domain's declared PC order."""

    def __init__(self, geometry: HBMGeometry, domain: MemoryDomain):
        domain.validate(geometry)
        self.geometry = geometry
        self.domain = domain
        self.words_per_pc = geometry.bytes_per_pc // 4
        assert self.words_per_pc % ALIGN_WORDS == 0, "PC must be block-aligned"
        self.blocks_per_pc = self.words_per_pc // ALIGN_WORDS
        self.pc_order: Tuple[int, ...] = tuple(domain.pc_ids)
        self._total_blocks = len(self.pc_order) * self.blocks_per_pc
        self._cursor = 0

    @property
    def free_words(self) -> int:
        return (self._total_blocks - self._cursor) * ALIGN_WORDS

    def alloc(self, n_words: int) -> Tuple[Segment, ...]:
        n_blocks = -(-n_words // ALIGN_WORDS)
        if self._cursor + n_blocks > self._total_blocks:
            raise CapacityError(
                self.domain.name, n_blocks * ALIGN_WORDS * 4,
                self.free_words * 4,
                f"{len(self.domain.pc_ids)} PCs x "
                f"{self.geometry.bytes_per_pc} B")
        segments: List[Segment] = []
        for i in range(n_blocks):
            blk_idx = self._cursor + i
            pc = self.pc_order[blk_idx // self.blocks_per_pc]
            blk = blk_idx % self.blocks_per_pc
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
        self._cursor += n_blocks
        return tuple(segments)


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
