"""Training launcher: ``--arch <id>`` end-to-end entry point (port of
:mod:`repro.launch.train`).

Wires together the data pipeline, the trainer, the undervolt plan, async
checkpointing, and crash / restore handling, with the reference's flags
and output lines.  It runs the reduced config (``--full-config`` the
full one) on the card; ``--device cpu`` runs the plain path on the host.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 100 --undervolt 0.93 --ckpt-dir /tmp/ck --resume

Over ranks, every rank runs the same command with its own ``--rank``
and the group's ``--world``, ``--addr``, ``--port`` and ``--mesh
DATA,MODEL`` (rank p at mesh position p, row-major); each trains its
rows of every global batch with its experts, checkpoints are written in
the logical layout, and only rank 0 prints the lines above:

  python -m repro_torch.launch.train --arch deepseek-v2-lite-16b \\
      --world 2 --rank R --addr 127.0.0.1 --port 29500 --mesh 1,2
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.domains import DeviceCrashError
from repro_torch.core.hbm import TPU_V5E
from repro_torch.data.pipeline import DataConfig, make_batch, make_rank_batch
from repro_torch.launch import ranks
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
    ap.add_argument("--mesh", default="",
                    help="DATA,MODEL: train on a rank mesh of this shape "
                    "(needs --world DATA*MODEL and this process's --rank)")
    ranks.add_rank_args(ap)
    args = ap.parse_args(argv)

    bundle = get_arch(args.arch)
    cfg = bundle.cfg if args.full_config else bundle.reduced
    dev = resolve_device(args.device)
    dist = group = None
    if args.mesh:
        from repro_torch.launch.mesh import make_rank_mesh
        from repro_torch.models.dist import DistContext
        if not args.port:
            raise SystemExit("--mesh needs the group's --port (and --addr, "
                             "--world, --rank)")
        group = ranks.init_ranks(
            addr=args.addr, port=args.port, world=args.world,
            rank=args.rank, devices=ranks.rank_devices(args.world, dev))
        dev = group.device
        dist = DistContext(mesh=make_rank_mesh(
            group, [int(n) for n in args.mesh.split(",")]))
    lead = group is None or group.rank == 0
    try:
        return _train(args, bundle, cfg, dev, dist, lead)
    finally:
        if group is not None:
            ranks.shutdown()


def _train(args, bundle, cfg, dev, dist, lead):
    try:
        plan = (aggressive_plan(v_unsafe=args.undervolt,
                                mitigation=args.mitigation,
                                geometry=TPU_V5E)
                if args.undervolt else guardband_plan(TPU_V5E))
    except DeviceCrashError as e:
        raise SystemExit(f"refusing to launch: {e}")

    report = plan.power_report(utilization=0.7)
    if lead:
        print(f"[undervolt] blended HBM savings "
              f"{report['blended_savings_x']:.2f}x, "
              f"{report['pcs_powered']}/{TPU_V5E.num_pcs} PCs powered")

    tc = trainer.TrainConfig(
        microbatches=args.microbatches,
        adamw=AdamWConfig(lr=args.lr, warmup_steps=10,
                          total_steps=args.steps),
        undervolt=plan, grad_compression=args.grad_compression)
    step_fn = trainer.make_train_step(bundle, cfg, tc, dist)
    state = trainer.init_state(bundle, cfg,
                               torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    dims = None
    if dist is not None:
        from repro_torch.launch.rankstate import split_state, state_expert_dims
        dims = state_expert_dims(bundle.module.param_specs(cfg))
        state = split_state(state, dims, dist.model_index, dist.model_size)
    if tc.grad_compression == "int8_ef":
        from repro_torch.optim.compress import init_ef
        state["ef"] = init_ef(state["params"])

    start = 0
    writer = None
    if args.ckpt_dir:
        writer = (ckpt.AsyncCheckpointer(args.ckpt_dir) if dist is None
                  else None)
        if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
            state, meta = (ckpt.restore(args.ckpt_dir, state) if dist is None
                           else ckpt.restore_ranks(args.ckpt_dir, state, dist,
                                                   dims))
            start = meta["step"]
            if lead:
                print(f"[resume] restored step {start}")

    def save(step, meta):
        if dist is None:
            writer.submit(step, state, meta)
        else:
            ckpt.save_ranks(args.ckpt_dir, step, state, dist, dims, meta)

    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch, seed=0)
    m = None
    for i in range(start, args.steps):
        host = (make_batch(dc, i, cfg) if dist is None else make_rank_batch(
            dc, i, dist.data_index, dist.data_size, args.microbatches, cfg))
        state, m = step_fn(state, trainer.device_batch(host, dev))
        if lead and (i % 10 == 0 or i == args.steps - 1):
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"gnorm {float(m['grad_norm']):.3f}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            save(i + 1, {"loss": float(m["loss"])})
    if args.ckpt_dir:
        save(args.steps, None if m is None else {"loss": float(m["loss"])})
        if writer:
            writer.finalize()
        if lead:
            print(f"[ckpt] final checkpoint at step {args.steps}")
    return state


if __name__ == "__main__":
    main()
