"""Quickstart: train a small LM with the paper's undervolting feature on
(the port's counterpart of the reference's ``examples/quickstart.py``).

A reduced llama3.2 config, synthetic Markov data, AdamW, and an undervolt
plan that keeps optimizer state in the guardband-safe domain while
weights ride an unsafe 0.93 V domain: each step's parameter words pass
through the stuck-at injection (one K1 launch per step on the card).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.hbm import TPU_V5E
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.base import get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import trainer
from repro_torch.training.undervolt import aggressive_plan

STEPS = 60


def train_config() -> trainer.TrainConfig:
    """The quickstart's plan, optimizer and microbatching."""
    return trainer.TrainConfig(
        microbatches=2,
        adamw=AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=200),
        undervolt=aggressive_plan(v_unsafe=0.93, geometry=TPU_V5E))


def data_config(vocab: int) -> DataConfig:
    return DataConfig(vocab=vocab, seq_len=64, global_batch=8, seed=1)


def main(argv=None) -> float:
    """Train ``STEPS`` steps; returns the final loss."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    bundle = get_arch("llama3.2-3b")
    cfg = bundle.reduced
    tc = train_config()
    plan = tc.undervolt
    step = trainer.make_train_step(bundle, cfg, tc)
    dev = resolve_device(args.device)
    state = trainer.init_state(bundle, cfg,
                               torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    dc = data_config(cfg.vocab)

    report = plan.power_report(utilization=0.7)
    print(f"undervolt plan: blended HBM power savings "
          f"{report['blended_savings_x']:.2f}x "
          f"({report['pcs_powered']} PCs powered)")
    for name, d in report["domains"].items():
        print(f"  domain {name}: {d['voltage']:.2f} V ({d['region']}), "
              f"{d['pcs']} PCs, savings {d['savings_x']:.2f}x")

    for i in range(STEPS):
        state, m = step(state, trainer.device_batch(make_batch(dc, i), dev))
        if i % 10 == 0:
            print(f"step {i:3d}  loss {float(m['loss']):.4f}  "
                  f"grad_norm {float(m['grad_norm']):.3f}  "
                  f"faults(uncorrectable) "
                  f"{int(m.get('uncorrectable_faults', 0))}")
    loss = float(m["loss"])
    print("final loss:", loss)
    if loss >= 5.0:
        raise AssertionError(f"training should make progress: final loss "
                             f"{loss} >= 5.0")
    return loss


if __name__ == "__main__":
    main()
