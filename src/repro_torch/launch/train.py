"""Training launcher: ``--arch <id>`` end-to-end entry point (port of
:mod:`repro.launch.train`).

Wires together the data pipeline, the trainer, the undervolt plan, async
checkpointing, and crash / restore handling, with the reference's flags
and output lines.  It runs the reduced config (``--full-config`` the
full one) on the card; ``--device cpu`` runs the plain path on the host.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 100 --undervolt 0.93 --ckpt-dir /tmp/ck --resume
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.domains import DeviceCrashError
from repro_torch.core.hbm import TPU_V5E
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.base import get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import trainer
from repro_torch.training.undervolt import aggressive_plan, guardband_plan


def main(argv=None):
    """Train; returns the final train state (on ``--device``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--undervolt", type=float, default=0.0,
                    help="unsafe-domain voltage; 0 = guardband plan")
    ap.add_argument("--mitigation", default="clamp",
                    choices=["none", "clamp"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8_ef"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full-size config")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    bundle = get_arch(args.arch)
    cfg = bundle.cfg if args.full_config else bundle.reduced
    dev = resolve_device(args.device)
    try:
        plan = (aggressive_plan(v_unsafe=args.undervolt,
                                mitigation=args.mitigation,
                                geometry=TPU_V5E)
                if args.undervolt else guardband_plan(TPU_V5E))
    except DeviceCrashError as e:
        raise SystemExit(f"refusing to launch: {e}")

    report = plan.power_report(utilization=0.7)
    print(f"[undervolt] blended HBM savings "
          f"{report['blended_savings_x']:.2f}x, "
          f"{report['pcs_powered']}/{TPU_V5E.num_pcs} PCs powered")

    tc = trainer.TrainConfig(
        microbatches=args.microbatches,
        adamw=AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps),
        undervolt=plan, grad_compression=args.grad_compression)
    step_fn = trainer.make_train_step(bundle, cfg, tc)
    state = trainer.init_state(bundle, cfg,
                               torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    if tc.grad_compression == "int8_ef":
        from repro_torch.optim.compress import init_ef
        state["ef"] = init_ef(state["params"])

    start = 0
    writer = None
    if args.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
            state, meta = ckpt.restore(args.ckpt_dir, state)
            start = meta["step"]
            print(f"[resume] restored step {start}")

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, seed=0)
    m = None
    for i in range(start, args.steps):
        batch = trainer.device_batch(make_batch(dc, i, cfg), dev)
        state, m = step_fn(state, batch)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"gnorm {float(m['grad_norm']):.3f}")
        if writer and (i + 1) % args.ckpt_every == 0:
            writer.submit(i + 1, state, {"loss": float(m["loss"])})
    if writer:
        writer.submit(args.steps, state,
                      None if m is None else {"loss": float(m["loss"])})
        writer.finalize()
        print(f"[ckpt] final checkpoint at step {args.steps}")
    return state


if __name__ == "__main__":
    main()
