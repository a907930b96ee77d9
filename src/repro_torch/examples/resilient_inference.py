"""EDEN-style resilient inference (the port's counterpart of the
reference's ``examples/resilient_inference.py``): serve a model with its
KV cache in an undervolted HBM domain and measure output degradation
against power saved.

At each voltage the trade-off solver's most reliable PCs hold the cache,
faults are injected through the real kernels every decode step (K3's
read path on the card), and greedy generations are compared with the
nominal-voltage reference.  The weights come from a seeded init, the
prompts from a numpy seed.

  PYTHONPATH=src python -m repro_torch.examples.resilient_inference [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
from repro_torch.core.hbm import VCU128
from repro_torch.core.voltage import DEFAULT_POWER_MODEL
from repro_torch.models.base import get_arch, init_params
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.training.undervolt import UndervoltPlan

VOLTAGES = (1.20, 0.98, 0.93, 0.89, 0.86)


def plan_at(v: float) -> UndervoltPlan:
    """The KV cache on the 16 most reliable PCs usable at ``v``."""
    fmap = FaultMap.from_seed(VCU128, seed=PAPER_MAP_SEED)
    pcs = tuple(int(p) for p in fmap.usable_pcs(v, 1.0))[:16] or tuple(
        range(16))
    return UndervoltPlan(
        domains={"kv": MemoryDomain("kv", v, pcs)},
        policy={"kv_cache": "kv"}, geometry=VCU128,
        map_seed=PAPER_MAP_SEED)


def sweep(bundle, cfg, params, prompts, voltages=VOLTAGES, device="cuda"):
    """Greedy generations of ``prompts`` (B, S) at each voltage (the first
    is the reference; 1.2 V serves without a plan): returns ``[(v, power
    savings, token agreement with the reference)]``."""
    rows, ref = [], None
    for v in voltages:
        sc = ServeConfig(max_len=64, max_new_tokens=16,
                         undervolt=plan_at(v) if v < 1.2 else None)
        toks = generate(bundle, cfg, params, {"tokens": prompts}, sc,
                        device=device).cpu().numpy()
        if ref is None:
            ref = toks
        rows.append((v, float(DEFAULT_POWER_MODEL.savings(v, 0.5)),
                     float((toks == ref).mean())))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bundle = get_arch("gemma3-4b")
    cfg = bundle.reduced
    params = init_params(bundle.module.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (4, 12)))
    rows = sweep(bundle, cfg, params, prompts, VOLTAGES, dev)
    for v, savings, agreement in rows:
        print(f"V={v:.2f}  power_savings={savings:4.2f}x  "
              f"token_agreement_vs_nominal={agreement:5.1%}")
    print("\nguardband serving is bit-identical; deeper voltages trade "
          "fidelity for power -- the paper's capacity/fault-rate/power "
          "triangle at the application level.")
    return rows


if __name__ == "__main__":
    main()
