"""Per-cell step plans: step function + input avals + shardings (port of
:mod:`repro.launch.specs`).

A *cell* is (architecture x input shape x mesh).  :func:`build_cell`
returns everything :mod:`repro_torch.launch.dryrun` needs: the step
callable, its argument avals (:class:`Aval` s; nothing is allocated),
their ParamSpecs and resolved PartitionSpecs.  The same step factories
drive real launches (:mod:`repro_torch.launch.train`).

In place of the reference's ``CellPlan.lower()`` (XLA's AOT lowering),
:meth:`CellPlan.analyze` runs the step once on the ``meta`` device under
:func:`repro_torch.launch.hlo_analysis.trace`, at one data shard's batch
with the mesh's model axis (the capacity and the expert dispatch of that
shard): its FLOPs, bytes and live temporaries divide evenly over the
model axis, an assumption the reference's compiled program does not
need.  The gradients the trace keeps are whole leaves, so ``temp``
overstates a cell whose rules shard the leaves over the batch axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.core import pytree
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import batch_axes, make_mesh_auto
from repro_torch.launch.sharding import (PartitionSpec, ShardingRules,
                                         resolve_spec, shard_shape,
                                         tree_shard_bytes, tree_shardings)
from repro_torch.models.base import (SHAPES, ArchBundle, Aval, ParamSpec,
                                     ShapeCell, get_arch, spec_avals)
from repro_torch.models.dist import DistContext
from repro_torch.training import trainer


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


@dataclasses.dataclass
class CellPlan:
    arch_id: str
    shape: ShapeCell
    mesh: Any
    step_fn: Any
    in_avals: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    layer_scan_trips: Dict[str, int]     # scan name -> trip count (roofline)
    microbatches: int = 1

    dist: Any = None
    # the port's additions: the inputs as ParamSpec trees, the rules, and
    # makes the step at one data shard's batch (see analyze)
    in_specs: Tuple[Any, ...] = ()
    rules: Any = None
    local_step: Any = None
    local_batch: int = 0

    def arg_bytes(self) -> int:
        """Exact bytes of one device's blocks of every input."""
        return sum(tree_shard_bytes(t, self.rules, self.mesh)
                   for t in self.in_specs)

    def donated_bytes(self) -> int:
        return sum(tree_shard_bytes(self.in_specs[i], self.rules, self.mesh)
                   for i in self.donate_argnums)

    def analyze(self):
        """Run the step once on the ``meta`` device at one data shard's
        batch (``local_batch`` rows) under the analysis: returns (the
        :class:`repro_torch.launch.hlo_analysis.StepTrace`, the trace's
        share of one device)."""
        step, args = self.local_step()
        _, st = hlo_analysis.trace(step, *args)
        shards = self.shape.global_batch // self.local_batch
        return st, shards / self.mesh.size

    def collective_layout(self):
        """Per parameter leaf: (per-device bytes as the compute uses it --
        gathered over the batch axes, still split over the model axis --,
        per-device bytes of its stored shard, sharded over the batch
        axes)."""
        if self.shape.kind != "train":
            return ()
        baxes = set(batch_axes(self.mesh))
        out = []
        for s, sh in zip(_spec_leaves(self.in_specs[0]["params"]),
                         _pspec_leaves(self.in_shardings[0]["params"])):
            used = tuple(None if (a in baxes or (isinstance(a, tuple)
                                                 and set(a) & baxes))
                         else a for a in sh)
            item = _itemsize(s.dtype)
            out.append((math.prod(shard_shape(s.shape, used, self.mesh))
                        * item,
                        math.prod(shard_shape(s.shape, sh, self.mesh))
                        * item,
                        used != tuple(sh)))
        return tuple(out)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _spec_leaves(tree):
    return pytree.leaves(tree, is_leaf=_is_spec)


def _pspec_leaves(tree):
    return pytree.leaves(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def _rules_for(shape: ShapeCell, overrides=None) -> ShardingRules:
    return ShardingRules.default(
        long_context=(shape.name == "long_500k"), overrides=overrides)


def _batch_avals(cfg, shape: ShapeCell, kind: str, batch=None):
    b = shape.global_batch if batch is None else batch
    if kind == "decode":
        toks = Aval((b, 1), torch.int32)
    else:
        s = shape.seq_len
        if cfg.family == "vlm":
            s = shape.seq_len - cfg.enc_len   # total context = seq_len
        toks = Aval((b, s), torch.int32)
    out = {"tokens": toks}
    if cfg.family == "vlm" and kind != "decode":
        out["patches"] = Aval((b, cfg.enc_len, cfg.frontend_dim),
                              torch.float32)
    if cfg.family == "audio" and kind != "decode":
        out["frames"] = Aval((b, cfg.enc_len, cfg.d_model), torch.float32)
    return out


def _batch_specs(batch_avals):
    return {k: ParamSpec(shape=a.shape,
                         axes=("batch",) + (None,) * (len(a.shape) - 1),
                         dtype=a.dtype)
            for k, a in batch_avals.items()}


def _dp_shards(mesh) -> int:
    return math.prod(mesh.shape[a] for a in batch_axes(mesh))


def pick_microbatches(shape: ShapeCell, mesh) -> int:
    """Default grad-accumulation factor: one sequence per DP shard per
    microbatch."""
    dp = _dp_shards(mesh)
    m = max(1, shape.global_batch // dp)
    while shape.global_batch % m or (shape.global_batch // m) % dp:
        m -= 1
    return max(m, 1)


def meta_tensors(tree):
    """A tree of :class:`Aval` s or ParamSpecs as ``meta`` tensors."""
    return pytree.tree_map(
        lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"), tree,
        is_leaf=lambda x: isinstance(x, (Aval, ParamSpec)))


def _local_mesh(mesh):
    """The mesh one data shard's trace runs on: the batch axes cut to 1,
    the model axis kept."""
    baxes = set(batch_axes(mesh))
    return make_mesh_auto(tuple(1 if a in baxes else n
                                for a, n in mesh.shape.items()),
                          mesh.axis_names, device="meta")


def build_cell(arch_id: str, shape_name: Union[str, ShapeCell], mesh,
               rule_overrides=None, microbatches: Optional[int] = None,
               undervolt=None, remat: Optional[str] = None,
               cfg=None) -> CellPlan:
    """The plan of one cell; ``shape_name`` may be a :class:`ShapeCell`
    and ``cfg`` a config of the arch (e.g. cut in depth) in place of the
    bundle's full one."""
    bundle = get_arch(arch_id)
    cfg = bundle.cfg if cfg is None else cfg
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    rules = _rules_for(shape, rule_overrides)
    dist = DistContext(mesh=mesh, batch_axes=batch_axes(mesh),
                       model_axis="model", rules=rules)
    scan_trips = _scan_trips(bundle, cfg)
    # one data shard's batch (the whole batch where the rules keep it
    # whole, e.g. long_500k's batch of one)
    (local,) = shard_shape((shape.global_batch,), resolve_spec(
        ParamSpec((shape.global_batch,), ("batch",)), rules, mesh), mesh)
    lmesh = _local_mesh(mesh)
    ldist = DistContext(mesh=lmesh, batch_axes=batch_axes(lmesh),
                        model_axis="model", rules=rules)
    common = dict(arch_id=arch_id, shape=shape, mesh=mesh,
                  layer_scan_trips=scan_trips, dist=dist, rules=rules,
                  local_batch=local)

    if shape.kind == "train":
        m = (microbatches if microbatches is not None
             else pick_microbatches(shape, mesh))
        tc = trainer.TrainConfig(microbatches=m, undervolt=undervolt)
        step = trainer.make_train_step(bundle, cfg, tc, dist)
        sspecs = trainer.state_specs(bundle, cfg, tc)
        state_sh = tree_shardings(sspecs, rules, mesh)
        batch_avals = _batch_avals(cfg, shape, "train")
        bspecs = _batch_specs(batch_avals)

        def local_step():
            return (trainer.make_train_step(bundle, cfg, tc, ldist),
                    (meta_tensors(sspecs), meta_tensors(
                        _batch_avals(cfg, shape, "train", local))))

        return CellPlan(
            step_fn=step, in_avals=(spec_avals(sspecs), batch_avals),
            in_shardings=(state_sh, tree_shardings(bspecs, rules, mesh)),
            out_shardings=(state_sh, None), donate_argnums=(0,),
            microbatches=m, in_specs=(sspecs, bspecs),
            local_step=local_step,
            **dict(common, layer_scan_trips={**scan_trips,
                                             "microbatch": m}))

    pspecs = bundle.module.param_specs(cfg)
    cache_len = shape.seq_len + (cfg.enc_len if cfg.family == "vlm" else 0)
    if shape.kind == "prefill":
        def prefill_step(params, batch, d=dist):
            return bundle.module.prefill(params, batch, cfg,
                                         shape.seq_len, d)
        cspecs = bundle.module.cache_specs(cfg, shape.global_batch,
                                           cache_len)
        batch_avals = _batch_avals(cfg, shape, "prefill")
        bspecs = _batch_specs(batch_avals)

        def local_step():
            return (lambda p, b: prefill_step(p, b, ldist),
                    (meta_tensors(pspecs), meta_tensors(
                        _batch_avals(cfg, shape, "prefill", local))))

        return CellPlan(
            step_fn=prefill_step,
            in_avals=(spec_avals(pspecs), batch_avals),
            in_shardings=(tree_shardings(pspecs, rules, mesh),
                          tree_shardings(bspecs, rules, mesh)),
            out_shardings=(None, tree_shardings(cspecs, rules, mesh)),
            donate_argnums=(), in_specs=(pspecs, bspecs),
            local_step=local_step, **common)

    # decode: one new token against a seq_len-deep cache
    def decode_step(params, cache, batch, pos, d=dist):
        return bundle.module.decode_step(params, cache, batch, pos, cfg, d)

    cspecs = bundle.module.cache_specs(cfg, shape.global_batch, cache_len)
    cache_sh = tree_shardings(cspecs, rules, mesh)
    batch_avals = _batch_avals(cfg, shape, "decode")
    bspecs = _batch_specs(batch_avals)
    pos_spec = ParamSpec((), (), torch.int32)

    def local_step():
        lc = bundle.module.cache_specs(cfg, local, cache_len)
        return (lambda p, c, b, pos: decode_step(p, c, b, pos, ldist),
                (meta_tensors(pspecs), meta_tensors(lc), meta_tensors(
                    _batch_avals(cfg, shape, "decode", local)),
                 shape.seq_len - 1))

    return CellPlan(
        step_fn=decode_step,
        in_avals=(spec_avals(pspecs), spec_avals(cspecs), batch_avals,
                  Aval((), torch.int32)),
        in_shardings=(tree_shardings(pspecs, rules, mesh), cache_sh,
                      tree_shardings(bspecs, rules, mesh),
                      resolve_spec(pos_spec, rules, mesh)),
        out_shardings=(None, cache_sh), donate_argnums=(1,),
        in_specs=(pspecs, cspecs, bspecs, pos_spec),
        local_step=local_step, **common)


def _scan_trips(bundle: ArchBundle, cfg) -> Dict[str, int]:
    """Known scan trip counts (the roofline's layer weighting)."""
    trips: Dict[str, int] = {}
    if hasattr(bundle.module, "layout"):
        trips["layers"] = bundle.module.layout(cfg).n_periods
    if cfg.family == "audio":
        from repro_torch.models import whisper as W
        trips["enc_layers"] = W.enc_layout(cfg).n_periods
        trips["layers"] = W.dec_layout(cfg).n_periods
    return trips
