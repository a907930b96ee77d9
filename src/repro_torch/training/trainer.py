"""Train step (port of :mod:`repro.training.trainer`): microbatched
gradient accumulation, AdamW, optional int8 + error-feedback gradient
compression, and an optional undervolt plan whose stuck-at faults land
on the parameters and moments right after the optimizer writes them.

The step works in place: AdamW updates the state's own tensors, and the
injected words (views of one packed arena per group,
:func:`repro_torch.core.engine.inject_placement`) are copied back into
them, so the parameters stay leaf tensors that require grad.  One K1
launch per unsafe group and step (K2 on an ECC domain) carries the
injection on the card.  Loss, norm, learning rate and fault counts stay
0-d tensors on the state's device: nothing in the step waits for the
device except what the caller reads.

On a rank mesh (a :class:`DistContext` over a process group) the state
is the rank's (:func:`repro_torch.launch.rankstate.split_state`: its
experts only) and the batch its data shard's rows
(:func:`repro_torch.data.pipeline.make_rank_batch`).  The gradients are
summed over the data ranks in rank order and divided by their count,
the loss and metrics averaged over them; with more than one model shard
(logical or ranks) the gradient norm sums each expert's squares on its
own, so the model ranks' parts add up to the logical mesh's bits; the
injection corrupts the rank's rows at the global placement's words
(:func:`repro_torch.launch.rankstate.rank_placement`) and the fault
counts add up over the model ranks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core import pytree
from repro_torch.launch import ranks
from repro_torch.launch.rankstate import expert_dims, rank_placement
from repro_torch.models.base import (ArchBundle, ArchConfig, init_params,
                                     spec_avals)
from repro_torch.models.dist import DistContext
from repro_torch.optim import adamw
from repro_torch.optim.compress import ef_quantize_grads
from repro_torch.training.undervolt import UndervoltPlan


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()
    undervolt: Optional[UndervoltPlan] = None
    grad_compression: str = "none"          # none | int8_ef
    # When set, a batch may carry a scalar under this key that overrides
    # the plan's *unsafe* domain voltages for the step (guardband domains
    # keep their protection).
    undervolt_voltage_key: Optional[str] = None
    undervolt_method: str = "auto"
    # Frontier-walking governor (repro_torch.training.governor): each step
    # re-plans the governed domain's voltage from a setpoint carried in
    # the batch under ``governor_key`` (else the governor's configured
    # one).  Exclusive with undervolt_voltage_key, and needs an explicit
    # undervolt_method ('word' | 'bitwise'), as in the reference.
    governor: Optional[Any] = None
    governor_key: Optional[str] = None


def _require_grad(params) -> None:
    for p in pytree.leaves(params):
        if not p.requires_grad:
            p.requires_grad_(True)


def init_state(bundle: ArchBundle, cfg: ArchConfig,
               generator: Optional[torch.Generator] = None, *,
               device="cuda") -> Dict[str, Any]:
    """Parameters from ``generator`` (see
    :func:`repro_torch.models.base.init_params`) and zeroed AdamW state,
    on ``device``."""
    params = init_params(bundle.module.param_specs(cfg), generator,
                         device=device)
    _require_grad(params)
    return {"params": params, "opt": adamw.init(params)}


def state_specs(bundle: ArchBundle, cfg: ArchConfig,
                tc: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """ParamSpecs of the whole train state."""
    pspecs = bundle.module.param_specs(cfg)
    out = {"params": pspecs, "opt": adamw.moment_specs(pspecs)}
    if tc is not None and tc.grad_compression == "int8_ef":
        out["ef"] = adamw.moment_specs(pspecs)["mu"]
    return out


def _placements(bundle, cfg, tc, dist=None):
    """The plan's placement of each group; on a rank mesh each cut to the
    rank's rows (at the global placement's words)."""
    if tc.undervolt is None or not tc.undervolt.enabled:
        return None
    pspecs = bundle.module.param_specs(cfg)
    mspecs = adamw.moment_specs(pspecs)
    specs = {"params": pspecs, "mu": mspecs["mu"], "nu": mspecs["nu"]}
    out = tc.undervolt.place({k: spec_avals(v) for k, v in specs.items()})
    if dist is not None and dist.on_ranks:
        out = {k: rank_placement(pl, specs[k], dist.model_index,
                                 dist.model_size) for k, pl in out.items()}
    return out


def _expert_square_sums(g, dim: int, chunk: int):
    """(outer, experts) sums of squares of an expert leaf's gradient, one
    reduction over each ``chunk`` experts (a model shard's): the chunk
    has one shape and layout whether it is a slice of the whole leaf (a
    logical mesh) or the leaf a model rank holds, so its sums have the
    same bits on both."""
    outer = math.prod(g.shape[:dim])
    rows = g.reshape(outer, g.shape[dim], -1)
    return torch.cat([rows[:, a:a + chunk].float().square().sum(-1)
                      for a in range(0, g.shape[dim], chunk)], dim=1)


def grad_norm(grads, edims: Dict[str, int], dist) -> torch.Tensor:
    """The global gradient norm of a mesh with model shards: an expert
    leaf's squares summed per expert, one model shard's experts at a time
    (gathered over the model ranks of a rank mesh), then over the whole
    (outer, experts) table; every other leaf as :func:`adamw.global_norm`
    sums it, the leaves in flatten order."""
    terms = []
    for path, g in pytree.flatten_with_path(grads):
        dim = edims.get(pytree.keystr(path))
        if dim is None:
            terms.append(g.float().square().sum())
            continue
        e = g.shape[dim]      # a rank holds one model shard's experts
        sums = _expert_square_sums(
            g, dim, e if dist.on_ranks else e // dist.model_size)
        if dist.on_ranks:
            sums = torch.cat(ranks.all_gather(
                dist.group, sums, dist.axis_group(dist.model_axis),
                kind="grad_norm"), dim=1)
        terms.append(sums.reshape(-1).sum())
    return torch.sqrt(sum(terms))


def device_batch(batch, device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy arrays, e.g. from ``make_batch``) on
    ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _like(params, flat):
    """A tree shaped like ``params`` holding ``flat`` in flatten order."""
    out = pytree.tree_map(lambda t: t, params)
    for (path, _), t in zip(pytree.flatten_with_path(params), flat):
        pytree.set_path(out, path, t)
    return out


@torch.no_grad()
def _write_back(groups, faulted) -> None:
    """Copy injected leaves (new tensors) into the state's own tensors."""
    for name, tree in groups.items():
        for old, new in zip(pytree.leaves(tree), pytree.leaves(faulted[name])):
            if new is not old:
                old.copy_(new)


def make_train_step(bundle: ArchBundle, cfg: ArchConfig, tc: TrainConfig,
                    dist: Optional[DistContext] = None):
    """Build the train step ``step(state, batch) -> (state, metrics)``.

    ``batch`` holds tensors on the state's device (and, under
    ``undervolt_voltage_key`` / ``governor_key``, a host scalar).  The
    state is updated in place and returned.  ``dist`` (a
    :class:`DistContext`) reaches the model's ``forward_train``: each
    microbatch's routed MoE FFN runs per data and model shard, on a
    logical mesh one after another, on a rank mesh this rank's."""
    module = bundle.module
    placements = _placements(bundle, cfg, tc, dist)
    on_ranks = dist is not None and dist.on_ranks
    edims = (expert_dims(module.param_specs(cfg))
             if dist is not None and dist.model_size > 1 else {})
    if on_ranks and tc.grad_compression != "none":
        raise ValueError("grad_compression on a rank mesh: the error "
                         "feedback would have to follow the data ranks' sum")
    if tc.governor is not None:
        if tc.undervolt_voltage_key is not None:
            raise ValueError(
                "TrainConfig.governor and undervolt_voltage_key are "
                "mutually exclusive voltage controls")
        if tc.undervolt is None or tc.governor.plan is not tc.undervolt:
            raise ValueError("tc.governor must be built from tc.undervolt")
        if tc.undervolt_method == "auto":
            raise ValueError(
                "TrainConfig.governor moves the voltage every step, which "
                "'auto' method dispatch would not follow (it dispatches "
                "from the configured domain voltages); set "
                "undervolt_method='word' or 'bitwise' explicitly")

    def grads_of(params, leaves, mb):
        loss, metrics = module.forward_train(params, mb, cfg, dist)
        grads = torch.autograd.grad(loss, leaves)
        return {k: v.detach() for k, v in metrics.items()}, grads

    def step(state, batch):
        params = state["params"]
        _require_grad(params)
        leaves = pytree.leaves(params)
        batch = dict(batch)

        uv_voltage = None
        governed_v = None
        if tc.governor is not None:
            setpoint = None
            if tc.governor_key is not None:
                setpoint = batch.pop(tc.governor_key, None)
            governed_v = tc.governor.voltage_at(
                None if setpoint is None else float(setpoint))
            uv_voltage = {tc.governor.config.domain: governed_v}
        elif tc.undervolt_voltage_key is not None:
            v = batch.pop(tc.undervolt_voltage_key, None)
            uv_voltage = None if v is None else float(v)

        m = tc.microbatches
        if m == 1:
            metrics, grads = grads_of(params, leaves, batch)
            grads = [g.to(torch.float32) for g in grads]
        else:
            for k, x in batch.items():
                if x.shape[0] % m:
                    raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows "
                                     f"does not split into {m} microbatches")
            parts, grads = [], None
            for i in range(m):
                mb = {k: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i]
                      for k, x in batch.items()}
                metrics_i, g = grads_of(params, leaves, mb)
                parts.append(metrics_i)
                if grads is None:   # float32 accumulators of their own
                    grads = [gg.to(torch.float32, copy=True) for gg in g]
                else:
                    for acc, gg in zip(grads, g):
                        acc.add_(gg)
                del g
            for acc in grads:
                acc.div_(m)
            # each forward metric (the loss, a MoE's xent and router aux)
            # as its mean over the microbatches
            metrics = {k: torch.stack([p[k] for p in parts]).mean()
                       for k in parts[0]}
        if on_ranks and dist.data_size > 1:
            n = dist.data_size
            grads = [ranks.ordered_sum(dist.group, g, dist.data_group,
                                       kind="grad_sum").div_(n)
                     for g in grads]
            metrics = {k: ranks.ordered_sum(dist.group, v, dist.data_group,
                                            kind="metrics") / n
                       for k, v in metrics.items()}
        grads = _like(params, grads)

        if tc.grad_compression == "int8_ef":
            grads, state["ef"] = ef_quantize_grads(grads, state["ef"])

        norm = grad_norm(grads, edims, dist) if edims else None
        _, _, opt_metrics = adamw.update(grads, state["opt"], params,
                                         tc.adamw, norm=norm)
        del grads
        metrics = {**metrics, **opt_metrics}

        if placements is not None:
            opt = state["opt"]
            groups = {"params": pytree.tree_map(lambda p: p.detach(), params),
                      "mu": opt["mu"], "nu": opt["nu"]}
            faulted, uv_metrics = tc.undervolt.apply(
                groups, placements, voltage=uv_voltage,
                method=tc.undervolt_method)
            _write_back(groups, faulted)
            del faulted
            if on_ranks and dist.model_size > 1:
                uv_metrics = {k: ranks.ordered_sum(
                    dist.group, v, dist.axis_group(dist.model_axis),
                    kind="fault_counts") for k, v in uv_metrics.items()}
            metrics = {**metrics, **uv_metrics}
            if governed_v is not None:
                metrics["governor_voltage"] = governed_v
        return state, metrics

    return step


def make_eval_loss(bundle: ArchBundle, cfg: ArchConfig,
                   dist: Optional[DistContext] = None):
    @torch.no_grad()
    def eval_loss(params, batch):
        loss, _ = bundle.module.forward_train(params, batch, cfg, dist)
        return loss
    return eval_loss
