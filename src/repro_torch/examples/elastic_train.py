"""Fault-tolerant training: undervolt crash -> checkpoint restore ->
resume (the port's counterpart of the reference's
``examples/elastic_train.py``).

The paper observes that below V_critical = 0.81 V the HBM part stops
responding and needs a power cycle.  At fleet scale that IS a node
failure.  This example drives a training run where an over-aggressive
voltage plan crashes a domain mid-run; the training loop catches the crash,
power-cycles (resets the domain to the guardband), restores the last
checkpoint, and continues on the same step -- bit-exact with an
uninterrupted run thanks to the deterministic data pipeline.  Like the
reference, it restores onto the same layout (no re-mesh).

  PYTHONPATH=src python -m repro_torch.examples.elastic_train [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.domains import DeviceCrashError, MemoryDomain
from repro_torch.core.hbm import TPU_V5E
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.base import get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import trainer
from repro_torch.training.undervolt import UndervoltPlan, guardband_plan


def main(argv=None):
    """Returns (the restored state's step, the final state, whether the
    over-aggressive plan crashed)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    bundle = get_arch("xlstm-350m")
    cfg = bundle.reduced
    dc = DataConfig(vocab=cfg.vocab, seq_len=48, global_batch=4, seed=9)
    adamw = AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=100)

    def make_step(plan):
        tc = trainer.TrainConfig(adamw=adamw, undervolt=plan)
        return trainer.make_train_step(bundle, cfg, tc)

    crashed = False
    with tempfile.TemporaryDirectory() as ckdir:
        step = make_step(guardband_plan(TPU_V5E))
        state = trainer.init_state(
            bundle, cfg, torch.Generator(device=dev).manual_seed(0),
            device=dev)
        i = 0
        while i < 10:
            state, m = step(state, trainer.device_batch(make_batch(dc, i),
                                                        dev))
            i += 1
        ckpt.save(ckdir, i, state)
        print(f"checkpointed at step {i}, loss {float(m['loss']):.4f}")

        # operator pushes the rail below V_critical: the part crashes
        try:
            bad = UndervoltPlan(
                domains={"all": MemoryDomain(
                    "all", 0.80, tuple(range(TPU_V5E.num_pcs)))},
                policy={"params": "all", "mu": "all", "nu": "all"},
                geometry=TPU_V5E)
            make_step(bad)
            raise AssertionError("should have crashed")
        except DeviceCrashError as e:
            crashed = True
            print(f"CRASH detected: {e}")
            print("power-cycling domain, restoring last checkpoint...")

        state, meta = ckpt.restore(ckdir, state)
        i = restored = meta["step"]
        step = make_step(guardband_plan(TPU_V5E))   # recovered voltage
        for _ in range(5):
            state, m = step(state, trainer.device_batch(make_batch(dc, i),
                                                        dev))
            i += 1
        print(f"resumed to step {i}, loss {float(m['loss']):.4f}")
        print("elastic restart complete -- the deterministic pipeline "
              "replays the exact same batches after restore.")
    return restored, state, crashed


if __name__ == "__main__":
    main()
