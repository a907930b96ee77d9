"""Per-rank train state of a rank mesh (beside :mod:`repro_torch.launch.
sharding`).

Expert parallelism's point is memory: a model rank holds only its own
experts' leaves -- rows ``[j * e_loc, (j + 1) * e_loc)`` along each
expert leaf's ``"experts"`` axis -- and their AdamW moments, and every
other leaf whole (replicated).  :func:`split_state` cuts a logical-mesh
state into one rank's; :func:`join_states` puts the model ranks' states
back together in model-rank order.

The undervolt plan places the *global* state once; a rank's expert rows
must take their faults at the same physical words as on the logical
mesh.  :func:`rank_placement` therefore slices each expert leaf's
segments of the global placement to the rank's rows (no smaller arena is
placed), so its arena blocks carry the global block table's rows, and
marks which blocks the rank counts: its expert blocks always, the
replicated leaves' blocks on model rank 0 only, so the model ranks'
fault counts add up to the logical mesh's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import pytree
from repro_torch.core.domains import (ALIGN_WORDS, GroupPlacement,
                                      LeafPlacement, Segment)
from repro_torch.launch.mesh import ShardLayoutError
from repro_torch.models.base import ParamSpec

EXPERT_AXIS = "experts"


def expert_dims(param_specs) -> Dict[str, int]:
    """``{keystr: dim}`` of every parameter leaf with an ``experts`` axis
    (paths relative to the parameter tree)."""
    out = {}
    for path, spec in pytree.flatten_with_path(
            param_specs, is_leaf=lambda x: isinstance(x, ParamSpec)):
        if EXPERT_AXIS in spec.axes:
            out[pytree.keystr(path)] = spec.axes.index(EXPERT_AXIS)
    return out


def state_expert_dims(param_specs) -> Dict[str, int]:
    """:func:`expert_dims` over a train state's paths: the parameters and
    both AdamW moments."""
    dims = expert_dims(param_specs)
    out = {}
    for prefix in ("['params']", "['opt']['mu']", "['opt']['nu']",
                   "['ef']"):
        out.update({prefix + k: d for k, d in dims.items()})
    return out


def _rows(n: int, model_index: int, model_size: int) -> slice:
    if n % model_size:
        raise ShardLayoutError(f"{n} experts do not split over {model_size} "
                               "model ranks")
    per = n // model_size
    return slice(model_index * per, (model_index + 1) * per)


def take_rows(t: torch.Tensor, dim: int, model_index: int,
              model_size: int) -> torch.Tensor:
    """Rank ``model_index``'s expert rows of ``t`` along ``dim``, as a
    tensor of their own."""
    sl = _rows(t.shape[dim], model_index, model_size)
    return t.narrow(dim, sl.start, sl.stop - sl.start).clone()


def split_state(state, dims: Dict[str, int], model_index: int,
                model_size: int):
    """One model rank's state: each leaf at a path of ``dims`` (keystr ->
    experts dim, e.g. :func:`state_expert_dims`) cut to the rank's rows,
    every other leaf kept as it is.  A leaf that required grad still
    does."""
    out = pytree.tree_map(lambda t: t, state)
    for path, leaf in pytree.flatten_with_path(state):
        dim = dims.get(pytree.keystr(path))
        if dim is None or model_size == 1:
            continue
        with torch.no_grad():
            t = take_rows(leaf.detach(), dim, model_index, model_size)
        if leaf.requires_grad:
            t.requires_grad_(True)
        pytree.set_path(out, path, t)
    return out


def join_states(states: Sequence[Any], dims: Dict[str, int]):
    """The logical state of the model ranks' ``states`` (in model-rank
    order): expert leaves concatenated along their experts dim, every
    other leaf rank 0's."""
    out = pytree.tree_map(lambda t: t, states[0])
    flats = [pytree.flatten_with_path(s) for s in states]
    for i, (path, leaf) in enumerate(flats[0]):
        dim = dims.get(pytree.keystr(path))
        if dim is None or len(states) == 1:
            continue
        pytree.set_path(out, path, torch.cat(
            [f[i][1].detach() for f in flats], dim=dim))
    return out


# ---- the undervolt plan's placement of one rank --------------------------


@dataclasses.dataclass(frozen=True)
class RankPlacement(GroupPlacement):
    """A :class:`GroupPlacement` of one rank's leaves at the global
    placement's physical words, and ``count_mask``: per arena block,
    whether this rank counts its fault events."""

    count_mask: Tuple[bool, ...] = ()


def _leaf_runs(shape, itemsize: int, dim: int, model_index: int,
               model_size: int, path: str):
    """The rank's rows of a leaf as runs ``[start, stop)`` of global leaf
    words, in the leaf's (row-major) order."""
    outer = math.prod(shape[:dim])
    n = shape[dim]
    inner = math.prod(shape[dim + 1:]) * itemsize
    sl = _rows(n, model_index, model_size)
    runs = []
    for o in range(outer):
        a = (o * n + sl.start) * inner
        b = (o * n + sl.stop) * inner
        if a % 4 or b % 4:
            raise ShardLayoutError(f"{path}: expert rows are not whole words")
        runs.append((a // 4, b // 4))
    return runs


def _slice_leaf(lp: LeafPlacement, runs) -> LeafPlacement:
    """``lp`` restricted to the leaf words of ``runs``, renumbered from 0
    in run order, each word at its global physical address."""
    segs, local = [], 0
    for a, b in runs:
        if a % ALIGN_WORDS or (b % ALIGN_WORDS and b != lp.n_words):
            raise ShardLayoutError(
                f"{lp.path}: a rank's expert rows [{a}, {b}) are not whole "
                f"{ALIGN_WORDS}-word arena blocks: its faults could not land "
                "on the logical mesh's words")
        for seg in lp.segments:
            lo = max(a, seg.leaf_start_word)
            hi = min(b, seg.leaf_start_word + seg.n_words)
            if lo >= hi:
                continue
            segs.append(Segment(
                leaf_start_word=local + lo - a, n_words=hi - lo, pc=seg.pc,
                phys_base_word=seg.phys_base_word + lo - seg.leaf_start_word))
        local += b - a
    return LeafPlacement(path=lp.path, n_words=local, segments=tuple(segs))


@functools.lru_cache(maxsize=64)
def _rank_placement(placement: GroupPlacement, dims: Tuple[Tuple[str, int]],
                    shapes: Tuple[Tuple[str, Tuple[int, ...], int]],
                    model_index: int, model_size: int) -> RankPlacement:
    dims_d = dict(dims)
    shape_d = {k: (s, i) for k, s, i in shapes}
    leaves, mask = [], []
    for lp in placement.leaves:
        dim = dims_d.get(lp.path)
        if dim is None or model_size == 1:
            new, counted = lp, model_index == 0
        else:
            shape, itemsize = shape_d[lp.path]
            new = _slice_leaf(lp, _leaf_runs(shape, itemsize, dim,
                                             model_index, model_size,
                                             lp.path))
            counted = True
        leaves.append(new)
        mask.extend([counted] * -(-new.n_words // ALIGN_WORDS))
    return RankPlacement(group=placement.group, domain=placement.domain,
                         leaves=tuple(leaves), count_mask=tuple(mask))


def rank_placement(placement: GroupPlacement, tree_specs,
                   model_index: int, model_size: int) -> RankPlacement:
    """The global ``placement`` of a group cut to one model rank's leaves
    (``tree_specs``: the group's ParamSpec tree, whose ``experts`` axes
    say which leaves are cut)."""
    is_spec = lambda x: isinstance(x, ParamSpec)  # noqa: E731
    dims, shapes = [], []
    for path, spec in pytree.flatten_with_path(tree_specs, is_leaf=is_spec):
        key = pytree.keystr(path)
        if EXPERT_AXIS in spec.axes:
            dims.append((key, spec.axes.index(EXPERT_AXIS)))
        shapes.append((key, tuple(spec.shape),
                       torch.empty((), dtype=spec.dtype).element_size()))
    return _rank_placement(placement, tuple(dims), tuple(shapes),
                           int(model_index), int(model_size))


# ---- state digests ------------------------------------------------------


def leaf_digest(t: torch.Tensor, chunk: int = 1 << 24) -> Tuple[int, int]:
    """Two int64 sums over a leaf's raw 32-bit words (plain, and weighted
    by a word-position hash), wrapping: equal bits give equal digests on
    any device, and a changed word changes them but with negligible
    odds.  Lets a rank compare a state of gigabytes without moving it."""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
    pad = (-raw.numel()) % 4
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    words = raw.view(torch.int32)
    s1 = s2 = 0
    mask = (1 << 64) - 1
    for w0 in range(0, words.numel(), chunk):
        w = words[w0:w0 + chunk].to(torch.int64)
        pos = torch.arange(w0, w0 + w.numel(), dtype=torch.int64,
                           device=w.device)
        weight = (pos * 2654435761) % 2147483629 + 1
        s1 = (s1 + int(w.sum())) & mask
        s2 = (s2 + int((w * weight).sum())) & mask
    return s1, s2


def state_digest(state) -> Dict[str, Tuple[int, int]]:
    """:func:`leaf_digest` of every leaf, by keystr."""
    return {pytree.keystr(p): leaf_digest(t)
            for p, t in pytree.flatten_with_path(state)}


def split_digest(state, dims: Dict[str, int], model_size: int
                 ) -> Dict[int, Dict[str, Tuple[int, int]]]:
    """Each model rank's :func:`state_digest` of a logical state, without
    holding more than one leaf's rows at a time."""
    out: Dict[int, Dict[str, Tuple[int, int]]] = {
        j: {} for j in range(model_size)}
    for path, leaf in pytree.flatten_with_path(state):
        key = pytree.keystr(path)
        dim = dims.get(key)
        for j in range(model_size):
            if dim is None or model_size == 1:
                out[j][key] = out[0][key] if j else leaf_digest(leaf)
            else:
                out[j][key] = leaf_digest(
                    take_rows(leaf.detach(), dim, j, model_size))
    return out


def leaf_samples(tree, n: int) -> Dict[str, np.ndarray]:
    """Up to ``n`` evenly strided words of every leaf, as float32 on the
    host, by keystr: what two states that cannot agree on bits (another
    summation order) are compared on when they are too large to move
    whole."""
    out = {}
    for p, t in pytree.flatten_with_path(tree):
        flat = t.detach().reshape(-1)
        stride = max(1, flat.numel() // n)
        out[pytree.keystr(p)] = flat[::stride][:n].float().cpu().numpy()
    return out
