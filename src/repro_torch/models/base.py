"""Model substrate: configs, parameter specs, registry (port of
:mod:`repro.models.base`).

Every family module exposes ``param_specs(cfg)``, ``cache_specs(cfg,
batch, seq)``, ``prefill``, ``decode_step`` and ``forward_train``.  A
:class:`ParamSpec` carries shape, dtype, logical axes and init rule;
:func:`spec_avals` turns specs into :class:`Aval` shape records, so
placement plans for full-scale models allocate nothing.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import pytree

CACHE_LAYOUTS = ("full", "window", "cross", "state")
CACHE_SLOT_AXIS = "cache_seq"


@dataclasses.dataclass(frozen=True)
class Aval:
    """Shape/dtype record of a tensor (the port's ShapeDtypeStruct)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype/logical-axes/init description of one parameter."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                 # normal | zeros | ones | const
    scale: float = 1.0
    layout: Optional[str] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)
        assert self.layout in (None,) + CACHE_LAYOUTS, self.layout

    @property
    def aval(self) -> Aval:
        return Aval(tuple(self.shape), self.dtype)


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_avals(specs) -> Any:
    return pytree.tree_map(lambda s: s.aval, specs, is_leaf=_is_spec)


def cache_slot_axes(specs) -> Any:
    """Per-leaf index of the ring-buffer slot axis, -1 for slotless state."""
    return pytree.tree_map(
        lambda s: (s.axes.index(CACHE_SLOT_AXIS)
                   if CACHE_SLOT_AXIS in s.axes else -1),
        specs, is_leaf=_is_spec)


def cache_batch_axes(specs) -> Any:
    """Per-leaf index of the serving-batch axis, located by name
    ('batch'), -1 for batch-free leaves.  Period-stacked leaves carry the
    layer stack in front, so the batch axis is not always dim 0."""
    return pytree.tree_map(
        lambda s: s.axes.index("batch") if "batch" in s.axes else -1,
        specs, is_leaf=_is_spec)


def leaf_layout(spec: ParamSpec, max_len: int) -> str:
    """Layout kind of one cache leaf (see CACHE_LAYOUTS)."""
    if spec.layout is not None:
        return spec.layout
    if CACHE_SLOT_AXIS in spec.axes:
        ln = spec.shape[spec.axes.index(CACHE_SLOT_AXIS)]
        return "full" if ln >= max_len else "window"
    return "state"


def cache_layouts(specs, max_len: int) -> Any:
    return pytree.tree_map(lambda s: leaf_layout(s, max_len), specs,
                           is_leaf=_is_spec)


def init_params(specs, generator: Optional[torch.Generator] = None, *,
                device="cuda") -> Any:
    """Materialize parameters from ``generator`` (normal init std
    ``scale / sqrt(fan_in)``, fan_in the second-to-last dim), drawn in
    float32 on ``device`` and cast, leaf by leaf in flatten order."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def mk(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        if s.init == "const":
            return torch.full(s.shape, s.scale, dtype=s.dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.scale / math.sqrt(max(fan_in, 1))
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w.mul_(std)).to(s.dtype)

    flat = pytree.flatten_with_path(specs, is_leaf=_is_spec)
    out = pytree.tree_map(lambda s: None, specs, is_leaf=_is_spec)
    for path, s in flat:
        pytree.set_path(out, path, mk(s))
    return out


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture (exact numbers from the public pool)."""

    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    pattern: Optional[Tuple[str, ...]] = None
    window: int = 0
    conv_width: int = 4
    lru_width: int = 0
    # enc-dec / vlm frontends: extra inputs the data pipeline makes
    enc_len: int = 0
    frontend_dim: int = 0
    # training: "block" recomputes each period in the backward pass
    remat: str = "block"        # none | block

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        if self.pattern is None:
            return ("global",) * self.n_layers
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    """Everything the serving entry points need for one architecture."""

    cfg: ArchConfig
    module: Any
    reduced: Optional[ArchConfig] = None


_REGISTRY: Dict[str, Callable[[], ArchBundle]] = {}


def register(arch_id: str, fn: Callable[[], ArchBundle]) -> None:
    _REGISTRY[arch_id] = fn


def get_arch(arch_id: str) -> ArchBundle:
    if arch_id not in _REGISTRY:
        mod = arch_id.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[arch_id]()

