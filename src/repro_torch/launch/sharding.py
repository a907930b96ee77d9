"""Logical-axis -> mesh-axis sharding rules (port of
:mod:`repro.launch.sharding`), with divisibility checking and ordered
fallbacks.

The default table gives: TP over 'model' for heads/ffn/vocab/experts,
FSDP-style 2D weight sharding ('embed' -> 'data', so every large matrix
is sharded over both axes and optimizer state is fully distributed),
batch over ('pod', 'data'), and optional sequence sharding for batch-1
long-context caches.  A rule that does not divide the dimension falls
back down its candidate list (e.g. internvl2's vocab 92553 is not
16-divisible -> replicated embedding rows), so every (arch x shape x
mesh) cell resolves without hand-tuning.

Resolution is pure logic over :class:`ParamSpec` s and a mesh's
``axis_names`` / ``shape``.  A resolved :class:`PartitionSpec` is a
tuple with one axis assignment per dimension: ``None`` (replicated), a
mesh-axis name, or a tuple of names.  :func:`shard_shape` gives the
per-device block it implies -- what the dry run adds up.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import pytree
from repro_torch.models.base import ParamSpec

AxisAssign = Union[None, str, Tuple[str, ...]]

# candidate lists, tried in order until one divides the dimension
DEFAULT_TABLE: Dict[str, Tuple[AxisAssign, ...]] = {
    "vocab": ("model", None),
    "embed": ("data", None),          # FSDP 2D weight sharding
    "heads": ("model", None),
    "kv": ("model", None),
    "mlp": ("model", None),
    "experts": ("model", None),
    "layers": (None,),
    "frontend": (None,),
    "batch": (("pod", "data"), ("data",), None),
    "cache_seq": (None,),
    "kv_heads": ("model", None),
    # kv_heads rarely divides the model axis (GQA); the fused fallback is
    # sharding the head_dim / MLA latent dim instead
    "head_dim": ("model", None),
    "kv_lora": ("model", None),
    # attention activations: heads replicated by default
    "attn_act_heads": (None,),
}

LONG_CONTEXT_OVERRIDES: Dict[str, Tuple[AxisAssign, ...]] = {
    # batch=1: shard the KV/cache sequence instead of the batch
    "batch": (None,),
    "cache_seq": ("data", None),
}


class PartitionSpec(tuple):
    """One axis assignment per dimension (``None``, a name or a tuple of
    names); equal to the plain tuple of its entries."""

    def __new__(cls, *axes: AxisAssign):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    table: Dict[str, Tuple[AxisAssign, ...]]

    @classmethod
    def default(cls, long_context: bool = False,
                overrides: Optional[Dict[str, Tuple[AxisAssign, ...]]] = None,
                ) -> "ShardingRules":
        table = dict(DEFAULT_TABLE)
        if long_context:
            table.update(LONG_CONTEXT_OVERRIDES)
        if overrides:
            table.update(overrides)
        return cls(table=table)


def _names(assign: AxisAssign) -> Tuple[str, ...]:
    if assign is None:
        return ()
    return (assign,) if isinstance(assign, str) else tuple(assign)


def _axis_size(mesh, assign: AxisAssign) -> int:
    return math.prod(mesh.shape[a] for a in _names(assign))


def resolve_spec(spec: ParamSpec, rules: ShardingRules,
                 mesh) -> PartitionSpec:
    """PartitionSpec for one ParamSpec under the rules and mesh: per
    dimension the first candidate whose axes (those in the mesh and not
    used by an earlier dimension) divide it; a ``None`` candidate stops
    the search."""
    out = []
    used: set = set()
    for dim, logical in zip(spec.shape, spec.axes):
        chosen: AxisAssign = None
        if logical is not None:
            for cand in rules.table.get(logical, (None,)):
                names = tuple(n for n in _names(cand)
                              if n in mesh.axis_names and n not in used)
                if not names:
                    if cand is None:
                        chosen = None
                        break
                    continue
                size = math.prod(mesh.shape[n] for n in names)
                if dim % size == 0:
                    chosen = names if len(names) > 1 else names[0]
                    used.update(names)
                    break
        out.append(chosen)
    return PartitionSpec(*out)


def tree_shardings(specs, rules: ShardingRules, mesh):
    """Tree of PartitionSpecs mirroring a tree of ParamSpecs."""
    return pytree.tree_map(lambda s: resolve_spec(s, rules, mesh), specs,
                           is_leaf=_is_spec)


def serve_sharding(mesh, axis: str = "serve") -> PartitionSpec:
    """Sharding for serving-scheduler state: leading axis split over the
    1-D ``serve`` mesh, every other axis replicated."""
    return PartitionSpec(axis)


def batch_sharding(mesh, rules: ShardingRules, ndim: int,
                   batch_dim_divisible: int) -> PartitionSpec:
    """PartitionSpec for a batch-leading input array."""
    spec = ParamSpec(shape=(batch_dim_divisible,) + (1,) * (ndim - 1),
                     axes=("batch",) + (None,) * (ndim - 1),
                     dtype=torch.int32)
    return resolve_spec(spec, rules, mesh)


def shard_shape(shape, pspec: PartitionSpec, mesh) -> Tuple[int, ...]:
    """The per-device block of a ``shape`` tensor laid out by ``pspec``
    (each dimension divided by the size of the axes it is split over)."""
    out = []
    for dim, assign in zip(shape, tuple(pspec) + (None,) * len(shape)):
        size = _axis_size(mesh, assign)
        if dim % size:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {assign} ({size})")
        out.append(dim // size)
    return tuple(out)


def shard_bytes(spec: ParamSpec, rules: ShardingRules, mesh) -> int:
    """Bytes of one device's block of ``spec`` under the rules."""
    block = shard_shape(spec.shape, resolve_spec(spec, rules, mesh), mesh)
    return math.prod(block) * torch.empty((), dtype=spec.dtype).element_size()


def tree_shard_bytes(specs, rules: ShardingRules, mesh) -> int:
    """Bytes of one device's blocks of every leaf of a ParamSpec tree."""
    return sum(shard_bytes(s, rules, mesh)
               for s in pytree.leaves(specs, is_leaf=_is_spec))
