"""Period layer stacking (port of :mod:`repro.models.stack`).

Every architecture repeats a short *period* of layer kinds.  Each slot of
the period has its own parameter/cache stack with a leading ``n_periods``
dim; the reference scans over periods, the port loops over them in
Python and hands each layer its views of the stacked leaves.  With
``remat`` (training, no cache) each period -- and each prefix or
remainder layer -- is recomputed in the backward pass
(``torch.utils.checkpoint``), where the reference wraps it in
``jax.checkpoint(..., nothing_saveable)``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

from torch.utils.checkpoint import checkpoint

from repro_torch.core import pytree
from repro_torch.models.base import ParamSpec


@dataclasses.dataclass(frozen=True)
class PeriodLayout:
    slots: Tuple[str, ...]
    n_periods: int
    remainder: Tuple[str, ...]
    prefix: Tuple[str, ...] = ()

    @property
    def n_layers(self) -> int:
        return (len(self.prefix) + len(self.slots) * self.n_periods
                + len(self.remainder))


def layout_from_kinds(kinds: Tuple[str, ...], period_len: int,
                      prefix_len: int = 0) -> PeriodLayout:
    prefix = tuple(kinds[:prefix_len])
    body = kinds[prefix_len:]
    n_periods = len(body) // period_len
    return PeriodLayout(slots=tuple(body[:period_len]), n_periods=n_periods,
                        remainder=tuple(body[period_len * n_periods:]),
                        prefix=prefix)


def _stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec(shape=(n,) + spec.shape, axes=("layers",) + spec.axes,
                     dtype=spec.dtype, init=spec.init, scale=spec.scale,
                     layout=spec.layout)


def _stacked(layout: PeriodLayout, slot_fn: Callable[[str], Any]):
    is_spec = lambda x: isinstance(x, ParamSpec)  # noqa: E731
    periods = {
        f"s{i}_{kind}": pytree.tree_map(
            lambda s: _stack_spec(s, layout.n_periods), slot_fn(kind),
            is_leaf=is_spec)
        for i, kind in enumerate(layout.slots)
    }
    rest = {f"r{i}_{kind}": slot_fn(kind)
            for i, kind in enumerate(layout.remainder)}
    pre = {f"p{i}_{kind}": slot_fn(kind)
           for i, kind in enumerate(layout.prefix)}
    return {"prefix": pre, "periods": periods, "rest": rest}


def stack_specs(layout: PeriodLayout,
                slot_specs: Callable[[str], Any]) -> Dict[str, Any]:
    """Parameter specs for the whole stack."""
    return _stacked(layout, slot_specs)


def stack_cache_specs(layout: PeriodLayout,
                      slot_cache: Callable[[str], Any]) -> Dict[str, Any]:
    """Decode-state specs mirroring the parameter layout."""
    return _stacked(layout, slot_cache)


def _index(tree, i: int):
    return pytree.tree_map(lambda t: t[i], tree)


def apply_stack(params: Dict[str, Any], x, layout: PeriodLayout,
                apply_slot: Callable[..., Any],
                cache: Optional[Dict[str, Any]] = None,
                with_slot_ref: bool = False, remat: bool = False):
    """Run the full layer stack, threading per-layer caches if given.

    ``apply_slot(kind, slot_params, x, slot_cache[, (key, idx)])`` returns
    ``(new_x, slot_cache)``; the slot cache holds views of the stacked
    leaves, so its in-place ring writes land in ``cache``.  With
    ``with_slot_ref`` it also receives the slot key and, for periodic
    slots, the period index (None for prefix/remainder layers).

    ``remat`` applies only where no cache is threaded (training): each
    period, and each prefix or remainder layer, keeps just its input for
    the backward pass and is recomputed there."""
    remat = remat and cache is None

    def call(kind, key, idx, p, x, c):
        if with_slot_ref:
            return apply_slot(kind, p, x, c, (key, idx))
        return apply_slot(kind, p, x, c)

    def layer(kind, key, p, c, x):
        return call(kind, key, None, p, x, c)[0]

    def period(pidx, x):
        for i, kind in enumerate(layout.slots):
            key = f"s{i}_{kind}"
            c = (_index(cache["periods"][key], pidx)
                 if cache is not None else None)
            x, _ = call(kind, key, pidx,
                        _index(params["periods"][key], pidx), x, c)
        return x

    def run(fn, x):
        if remat:
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)

    for i, kind in enumerate(layout.prefix):
        key = f"p{i}_{kind}"
        c = cache["prefix"][key] if cache is not None else None
        x = run(functools.partial(layer, kind, key, params["prefix"][key], c),
                x)
    for pidx in range(layout.n_periods):
        x = run(functools.partial(period, pidx), x)
    for i, kind in enumerate(layout.remainder):
        key = f"r{i}_{kind}"
        c = cache["rest"][key] if cache is not None else None
        x = run(functools.partial(layer, kind, key, params["rest"][key], c),
                x)
    return x, cache
