#!/usr/bin/env python3
"""Which teardown, run by Python's cyclic garbage collector in the middle
of a CUDA-graph capture, invalidates that capture.

    python3 scripts/capture_gc_probe.py [--out build/capture_gc_probe.json]

Run from the root of a checkout, on one CUDA card.  Each case builds a
victim -- nothing, a replayed ``torch.cuda.CUDAGraph``, a pinned host
buffer that fed a non-blocking copy, a recorded ``torch.cuda.Event``, or
a warmed-up and captured ``repro_torch.serving.captured.CapturedStep`` --
holds it in a reference cycle and drops it, then captures a small body
(a matmul, ``gc.collect()``, an add) on a side stream with
``torch.cuda.graph`` in the ``global`` or ``thread_local`` error mode, so
the victim is torn down inside the capture.  A case passes when the
capture ends and its replay equals the eager body.  Every case runs in a
process of its own (a failed capture can leave the context unusable).
It prints one JSON line per case and exits 0 whatever the outcome (it
probes, it does not gate).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VICTIMS = ("none", "graph", "pinned", "event", "step")
MODES = ("global", "thread_local")


class _Cycle:
    """Holds ``obj`` in a reference cycle: only the cyclic collector
    frees it."""

    def __init__(self, obj):
        self.obj, self.me = obj, self


def make_victim(kind: str, dev):
    import torch
    x = torch.randn(256, 256, device=dev)
    if kind == "none":
        return None
    if kind == "graph":
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            (x @ x).sum()
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.cuda.graph(g):
            y = x @ x
        g.replay()
        torch.cuda.synchronize(dev)
        return _Cycle((g, y))
    if kind == "pinned":
        host = torch.empty(4096, pin_memory=True)
        torch.empty(4096, device=dev).copy_(host, non_blocking=True)
        return _Cycle(host)
    if kind == "event":
        ev = torch.cuda.Event()
        ev.record()
        return _Cycle(ev)
    if kind == "step":
        from repro_torch.serving.captured import CapturedStep
        w = torch.randn(256, 256, device=dev)

        def body():
            x.copy_(torch.tanh(x @ w))
            return x

        step = CapturedStep(body, dev)
        step()
        step()
        step()
        torch.cuda.synchronize(dev)
        return _Cycle(step)
    raise ValueError(kind)


def case(kind: str, mode: str) -> dict:
    import gc
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    a = torch.randn(512, 512, device=dev)

    def body():
        y = a @ a
        gc.collect()
        return y + 1.0

    want = body()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()                                  # warm-up (cuBLAS on side)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    victim = make_victim(kind, dev)
    del victim
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g, stream=side, capture_error_mode=mode):
            out = body()
        g.replay()
        torch.cuda.synchronize(dev)
        ok = bool(torch.equal(out, want))
        return dict(victim=kind, mode=mode, captured=True, equal=ok)
    except Exception as e:                        # noqa: BLE001 -- probed
        return dict(victim=kind, mode=mode, captured=False,
                    error=f"{type(e).__name__}: {str(e).splitlines()[0]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "capture_gc_probe.json"))
    ap.add_argument("--case", nargs=2, metavar=("VICTIM", "MODE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.case:
        print(json.dumps(case(*args.case)), flush=True)
        return 0
    rows = []
    for kind in VICTIMS:
        for mode in MODES:
            p = subprocess.run([sys.executable, __file__, "--case", kind,
                                mode], capture_output=True, text=True,
                               timeout=300)
            line = (p.stdout.strip().splitlines() or [""])[-1]
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                row = dict(victim=kind, mode=mode, captured=False,
                           error=f"rc {p.returncode}: "
                                 f"{p.stderr.strip()[-300:]}")
            print(json.dumps(row), flush=True)
            rows.append(row)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
