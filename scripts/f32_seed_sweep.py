#!/usr/bin/env python3
"""How often reduced recurrentgemma-9b in float32 serves the CPU's greedy
tokens on the card, over weight and token seeds, through each float32
variant of the prefill flash-attention kernel K7.

    python3 scripts/f32_seed_sweep.py [--weight-seeds 8] [--token-seeds 2]
        [--out build/f32_seed_sweep.json]

Run from the root of a checkout, on one CUDA card.  For every (weight
seed, token seed) it runs the check of ``chip_smoke.py``'s
``hybrid_small_input_check`` once per K7 variant ("tf32x3", the one
float32 takes, and "simt", its CUDA-core yardstick, forced by replacing
the variant choice of ``kernels/flash_attention/ops.py``): prefill logits
on the card against the CPU's (plain versions), and greedy tokens card vs
CPU clean, at 0.875 V with write-path faults and at 0.868 V with ECC.
The ECC mode corrects or flags words by their stored bits, so it is the
mode that sees the low bits of the prefilled cache.  It prints one line
per seed pair and a summary of pass counts per variant and mode; it
exits 0 whatever the counts (it measures, it does not gate).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("tf32x3", "simt")
MODES = ((None, False), (0.875, False), (0.868, True))
PROMPT, NEW, MAX_LEN, BATCH = 13, 8, 40, 2


def mode_name(v, ecc):
    return "clean" if v is None else f"{v}V" + ("_ecc" if ecc else "")


def sweep(dev, weight_seeds, token_seeds):
    """Pass counts per variant and mode, and per-seed rows."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.core.domains import MemoryDomain
    from repro_torch.core.hbm import VCU128
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.base import get_arch, init_params
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.training.undervolt import UndervoltPlan

    bundle = get_arch("recurrentgemma-9b")
    cfg = dataclasses.replace(bundle.reduced, dtype=torch.float32)
    picked = fops.pick_variant
    configs = []
    for v, ecc in MODES:
        plan = None if v is None else UndervoltPlan(
            domains={"kv": MemoryDomain("kv", v, tuple(range(32)), ecc=ecc)},
            policy={"kv_cache": "kv"}, geometry=VCU128)
        configs.append((mode_name(v, ecc), ServeConfig(
            max_len=MAX_LEN, max_new_tokens=NEW, undervolt=plan,
            kv_injection="write")))
    rows = []
    passes = {var: {name: 0 for name, _ in configs} for var in VARIANTS}
    max_err = {var: 0.0 for var in VARIANTS}
    for ws in weight_seeds:
        params = init_params(bundle.module.param_specs(cfg),
                             torch.Generator().manual_seed(ws), device="cpu")
        params_dev = pytree.tree_map(lambda t: t.to(dev), params)
        for ts in token_seeds:
            tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                                   generator=torch.Generator().manual_seed(ts))
            cl, _ = bundle.module.prefill(params, {"tokens": tokens}, cfg,
                                          MAX_LEN)
            cpu = {name: generate(bundle, cfg, params, {"tokens": tokens}, sc,
                                  device="cpu") for name, sc in configs}
            row = dict(weight_seed=ws, token_seed=ts)
            for var in VARIANTS:
                fops.pick_variant = lambda dtype, d, var=var: (
                    var if dtype == torch.float32 else picked(dtype, d))
                try:
                    _build.reset_launch_counts()
                    gl, _ = bundle.module.prefill(
                        params_dev, {"tokens": tokens.to(dev)}, cfg, MAX_LEN)
                    served = _build.variant_counts("flash_prefill")
                    if set(served) != {var}:
                        raise AssertionError(f"K7 served {served}, not {var}")
                    err = float((gl.cpu() - cl).abs().max())
                    equal = {}
                    for name, sc in configs:
                        gpu = generate(bundle, cfg, params_dev,
                                       {"tokens": tokens}, sc,
                                       device=dev).cpu()
                        equal[name] = bool(torch.equal(cpu[name], gpu))
                        passes[var][name] += equal[name]
                finally:
                    fops.pick_variant = picked
                max_err[var] = max(max_err[var], err)
                row[var] = dict(logit_err=err, tokens_equal=equal)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return dict(pairs=len(rows), passes=passes, max_logit_err=max_err,
                rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weight-seeds", type=int, default=8)
    ap.add_argument("--token-seeds", type=int, default=2)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("f32_seed_sweep.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # token seed 3 and weight seed 0 are chip_smoke.py's own
    report = sweep(torch.device("cuda", 0), range(args.weight_seeds),
                   range(3, 3 + args.token_seeds))
    report["card"] = card
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({k: report[k] for k in ("pairs", "passes",
                                             "max_logit_err")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
