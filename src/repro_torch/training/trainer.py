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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.core import pytree
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


def _placements(bundle, cfg, tc):
    if tc.undervolt is None or not tc.undervolt.enabled:
        return None
    pspecs = bundle.module.param_specs(cfg)
    mspecs = spec_avals(adamw.moment_specs(pspecs))
    groups = {"params": spec_avals(pspecs), "mu": mspecs["mu"],
              "nu": mspecs["nu"]}
    return tc.undervolt.place(groups)


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
    state is updated in place and returned.  ``dist`` (a logical mesh's
    :class:`DistContext`) reaches the model's ``forward_train``: each
    microbatch's routed MoE FFN runs per data and model shard."""
    module = bundle.module
    placements = _placements(bundle, cfg, tc)
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
        grads = _like(params, grads)

        if tc.grad_compression == "int8_ef":
            grads, state["ef"] = ef_quantize_grads(grads, state["ef"])

        _, _, opt_metrics = adamw.update(grads, state["opt"], params,
                                         tc.adamw)
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
