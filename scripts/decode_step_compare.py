#!/usr/bin/env python3
"""llama3.2-3b generate() decode on one CUDA card, timed and counted the
same way for any checkout of the port, so two commits can be compared in
one call.

    python3 scripts/decode_step_compare.py --src DIR/src --label NAME
        [--out build/decode_step_compare_NAME.json]

``--src`` is the ``src`` directory of the checkout to measure (its
``repro_torch`` is imported from there; kernels build under that
checkout's ``build/``).  The cell is ``chip_smoke.py``'s llama
generate() cell: full width, bf16, seeded weights, batch 4, prompt 128,
max_len 1024; modes clean and 0.88 V write.  For each mode and each way
the checkout can run the decode step -- ``eager`` (``capture=False``
where ``generate()`` has that keyword, else its only loop),
``eager_timed`` (eager with ``timings=``, which since the captured step
synchronises the device after every step) and ``captured`` -- it reports:

  * ``ms_per_token``: (wall time of generate() at 20 new tokens - at 4)
    / 16, each the median of 3 runs, the device synchronised at the end
    (prefill, injection and the first steps cancel out);
  * ``device_ops_per_step`` / ``host_ops_per_step``: device ops
    (kernels, memcpy, memset) and host-side ATen ops of a torch.profiler
    trace, (count at 20 - count at 4) / 16;
  * ``busy_ms_per_step``: the union of the device ops' intervals, by the
    same difference;
  * ``outer_host_ops``: the ATen ops called from Python (not from inside
    another op) per step, as (name, calls, host us), largest first.

It prints one JSON line per (mode, way) and the card's name and power
limit; it exits 0 (it measures, it does not gate).
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, PROMPT, MAX_LEN = 4, 128, 1024
N1, N2, REPS = 4, 20, 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def plan_at(v: float):
    """KV-cache domain on the 16 most reliable PCs at v, as chip_smoke.py
    places it."""
    from repro_torch.core.domains import MemoryDomain
    from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
    from repro_torch.core.hbm import VCU128
    from repro_torch.training.undervolt import UndervoltPlan
    fmap = FaultMap.from_seed(VCU128, seed=PAPER_MAP_SEED)
    pcs = tuple(int(p) for p in fmap.usable_pcs(v, 1.0))[:16] or tuple(
        range(16))
    return UndervoltPlan(domains={"kv": MemoryDomain("kv", v, pcs)},
                         policy={"kv_cache": "kv"}, geometry=VCU128,
                         map_seed=PAPER_MAP_SEED)


def trace_counts(path: Path) -> tuple:
    """(device ops, host ATen ops, device busy us, {name: [calls, us]} of
    the outermost host ATen ops) of a chrome trace."""
    events = json.loads(path.read_text())["traceEvents"]
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    host = sorted((float(e["ts"]), float(e.get("dur", 0)), e["name"])
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    busy, end = 0.0, float("-inf")
    for a, b in ops:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    outer, end = {}, float("-inf")
    for t, dur, name in host:            # an op inside another is skipped
        if t >= end:
            calls = outer.setdefault(name, [0, 0.0])
            calls[0] += 1
            calls[1] += dur
            end = t + dur
    return len(ops), len(host), busy, outer


def outer_delta(lo: dict, hi: dict, steps: int, top: int = 12) -> list:
    """The outermost host ATen ops per decode step, (name, calls, us),
    largest host time first."""
    rows = []
    for name in set(lo) | set(hi):
        a, b = lo.get(name, [0, 0.0]), hi.get(name, [0, 0.0])
        rows.append((name, (b[0] - a[0]) / steps, (b[1] - a[1]) / steps))
    return sorted(rows, key=lambda r: -r[2])[:top]


def measure(src: str, label: str) -> list:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.base import get_arch, init_params
    from repro_torch.serving import engine as serving
    dev = torch.device("cuda", 0)
    bundle = get_arch("llama3.2-3b")
    cfg = bundle.cfg
    params = init_params(bundle.module.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
    has_capture = "capture" in inspect.signature(serving.generate).parameters
    ways = {"eager": dict(capture=False) if has_capture else {}}
    if has_capture:
        ways["eager_timed"] = dict(capture=False, timed=True)
        ways["captured"] = dict(capture=True)
    trace = ROOT / "build" / f"decode_step_compare_{label}.trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for mode, v in (("clean", None), ("write", 0.88)):
        for way, kw in ways.items():
            kw = dict(kw)
            timed = kw.pop("timed", False)

            def run(n):
                sc = serving.ServeConfig(
                    max_len=MAX_LEN, max_new_tokens=n,
                    undervolt=None if v is None else plan_at(v),
                    kv_injection="auto" if v is None else mode)
                extra = dict(kw, timings={}) if timed else kw
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = serving.generate(bundle, cfg, params,
                                        {"tokens": prompts}, sc, device=dev,
                                        **extra)
                torch.cuda.synchronize()
                return time.perf_counter() - t0, toks

            run(N1)                                   # builds, warms up
            walls = {n: statistics.median(run(n)[0] for _ in range(REPS))
                     for n in (N1, N2)}
            counts = {}
            for n in (N1, N2):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    run(n)
                prof.export_chrome_trace(str(trace))
                counts[n] = trace_counts(trace)
            trace.unlink()
            d = N2 - N1
            rows.append(dict(
                label=label, mode=mode, way=way,
                ms_per_token=1e3 * (walls[N2] - walls[N1]) / d,
                device_ops_per_step=(counts[N2][0] - counts[N1][0]) / d,
                host_ops_per_step=(counts[N2][1] - counts[N1][1]) / d,
                busy_ms_per_step=(counts[N2][2] - counts[N1][2]) / d / 1e3,
                outer_host_ops=outer_delta(counts[N1][3], counts[N2][3], d),
                wall_s={str(n): w for n, w in walls.items()}))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = measure(args.src, args.label)
    out = Path(args.out or ROOT / "build" /
               f"decode_step_compare_{args.label}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
