"""AdamW with decoupled weight decay, cosine schedule and global
grad-norm clipping (port of :mod:`repro.optim.adamw`).

Moments are float32 whatever the parameter dtype.  The update runs in
place under ``torch.no_grad()`` on the state's own tensors, with the
reference's float32 arithmetic in the reference's order: the clip scale,
then ``mu``, ``nu``, ``m_hat``, ``v_hat`` and the decoupled weight
decay, the result cast to the parameter's dtype.  The reference runs it
as ``jnp`` outside any Pallas kernel, so plain PyTorch is its
counterpart.  Step, learning rate and norm stay 0-d tensors on the
state's device: nothing here waits for the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import pytree
from repro_torch.models.base import ParamSpec


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def moment_specs(param_specs) -> Dict[str, Any]:
    """ParamSpecs of the optimizer state: float32 moments with the
    parameters' shapes and axes, and the int32 step."""
    def f32(s: ParamSpec) -> ParamSpec:
        return ParamSpec(shape=s.shape, axes=s.axes, dtype=torch.float32,
                         init="zeros")
    m = pytree.tree_map(f32, param_specs,
                        is_leaf=lambda x: isinstance(x, ParamSpec))
    return {"mu": m, "nu": m,
            "step": ParamSpec((), (), torch.int32, "zeros")}


def _zeros_like_f32(params):
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def init(params) -> Dict[str, Any]:
    leaves = pytree.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"mu": _zeros_like_f32(params), "nu": _zeros_like_f32(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Learning rate at ``step`` (a 0-d int tensor): linear warmup, then
    cosine decay to ``min_lr_ratio``, in float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum()
                          for g in pytree.leaves(tree)))


@torch.no_grad()
def update(grads, opt_state, params,
           cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any], Dict[str, Any]]:
    """One AdamW step, in place on ``params`` and ``opt_state``.

    ``grads``: tensors shaped like ``params`` (read, not written).
    Returns (params, opt_state, metrics); the first two are the objects
    the caller passed."""
    opt_state["step"].add_(1)
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, sf)
    c2 = 1.0 - torch.pow(b2, sf)
    for p, g, mu, nu in zip(pytree.leaves(params), pytree.leaves(grads),
                            pytree.leaves(opt_state["mu"]),
                            pytree.leaves(opt_state["nu"])):
        g = g.float() * scale
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_(g.square_().mul_(1 - b2))
        del g
        delta = (mu / c1).div_((nu / c2).sqrt_().add_(cfg.eps))
        p32 = p.float()
        delta.add_(cfg.weight_decay * p32).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p32.sub_(delta))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
