#!/usr/bin/env python3
"""Training and held-out loss of ``chip_smoke.py``'s full-width training
cell over 12 steps, per AdamW peak learning rate and warmup, with no
undervolt plan, on one CUDA card.

    python3 scripts/train_lr_probe.py [--out build/train_lr_probe.json]

The cell: llama3.2-3b at full width cut to 8 layers, bf16, seeded init,
global batch 8 x 1024 from ``DataConfig(vocab=128256, seq_len=1024,
global_batch=8, seed=7)``, microbatches 2.  For each (lr, warmup) it
prints the loss of every step, the gradient norm of every step and the
loss of a held-out batch (4 sequences of step 10,000's batch) before the
first step and after steps 3, 6, 9 and 12, then the card's name and
power limit.  It shows which learning rate lets this init -- at the
uniform floor, ln(128,256) + 0.014 -- fall in 12 steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = ((3e-4, 2), (1e-4, 2), (3e-4, 12), (1e-4, 12), (3e-5, 2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_lr_probe.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.base import get_arch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import trainer
    dev = torch.device("cuda", 0)
    bundle = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(bundle.cfg, n_layers=8)
    dc = DataConfig(vocab=cfg.vocab, seq_len=1024, global_batch=8, seed=7)
    eval_loss = trainer.make_eval_loss(bundle, cfg)
    held = {k: v[:4] for k, v in trainer.device_batch(
        make_batch(dc, 10_000), dev).items()}
    rows = []
    for lr, warmup in SETTINGS:
        state = trainer.init_state(
            bundle, cfg, torch.Generator(device=dev).manual_seed(0),
            device=dev)
        step = trainer.make_train_step(bundle, cfg, trainer.TrainConfig(
            microbatches=2, adamw=AdamWConfig(lr=lr, warmup_steps=warmup)))
        row = {"lr": lr, "warmup_steps": warmup, "losses": [],
               "grad_norm": [],
               "held_out": [float(eval_loss(state["params"], held))]}
        for i in range(12):
            state, m = step(state, trainer.device_batch(make_batch(dc, i),
                                                        dev))
            row["losses"].append(float(m["loss"]))
            row["grad_norm"].append(float(m["grad_norm"]))
            if i % 3 == 2:
                row["held_out"].append(float(eval_loss(state["params"],
                                                       held)))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del state, step
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
