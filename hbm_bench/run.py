"""The benchmark's entry: one run of one cell.

    python3 -m hbm_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  The cell, its configuration, its
traffic mix and its metrics are found by name in ``BENCHMARK.json``:
``hbm_bench/configs/<config>.json``, ``hbm_bench/traffic/<traffic>.json``
and ``hbm_bench/metrics/<metric>.py``.  The configuration names the
module that builds the system under test (``hbm_bench/<system>.py``) and
the plain reference (``hbm_bench/reference/<reference>.py``).

A run draws the weights on the card from the seed, builds the program's
scheduler, warms up the cell's shapes and serves every client's first
request up to its first token (all of that is set-up), then serves a
closed loop -- one client a serving slot, each sending its next request
when the last completes -- for ``--seconds``, stamping every step's end
on the host clock.  With ``--trace 1`` one stretch of the
window runs under the profiler and the line carries the per-layer
metrics; otherwise it carries the end-to-end ones.  After the window it
frees the program and compares a sample of the finished requests with
the reference.  The last line of standard output is one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional


def _process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start / ticks
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


T_PROCESS = _process_start()
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

from hbm_bench import metrics as M                      # noqa: E402
from hbm_bench import peaks                             # noqa: E402
from hbm_bench import tracing                           # noqa: E402
from hbm_bench.loadgen import Traffic, load_mix         # noqa: E402
from hbm_bench.reference import compare                 # noqa: E402
from hbm_bench.window import RequestLog, account        # noqa: E402


class HarnessError(RuntimeError):
    """The program broke a rule the harness's accounting rests on."""


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class StepRecord:
    index: int
    kind: str            # mixed | decode
    loop_s: float        # wall time of this turn of the serving loop
    step_s: float        # the scheduler's own timing of the step
    admit_s: float       # the admission call before it
    free_pages: Optional[int]
    prefill_tokens: int  # prompt tokens the step took
    traced: bool


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""

    cfg: dict
    setup_s: float
    steps: List[StepRecord]
    account: object
    num_pages: int
    stretch: Optional[dict]

    def untraced(self):
        return [s for s in self.steps if not s.traced]

    def decode_ctx(self, index: int):
        return self.account.decode_ctx.get(index, [])

    def step_flops(self, index: int) -> float:
        """Model FLOPs of step ``index``: its prompt chunks and decoded
        positions, and the output head of each token it gave."""
        acc, head = self.account, peaks.head_flops(self.cfg)
        w, per_key = peaks.position_work(self.cfg)
        flops = 0.0
        for c0, n in acc.prefill.get(index, []):
            flops += n * w + per_key * (n * c0 + n * (n + 1) / 2.0)
        for ctx in self.decode_ctx(index):
            flops += w + per_key * ctx
        return flops + acc.tokens.get(index, 0) * head

    def decode_bytes(self, index: int) -> float:
        ctx = self.decode_ctx(index)
        return (peaks.weight_bytes(self.cfg)
                + sum(ctx) * peaks.kv_bytes_per_position(self.cfg))


class ClosedLoop:
    """One client a serving slot; each sends its next request when its
    last one completes."""

    def __init__(self, sched, system, traffic, mix, cfg, spans):
        self.sched, self.system, self.traffic = sched, system, traffic
        self.mix, self.cfg, self.spans = mix, cfg, spans
        self.logs: Dict[int, RequestLog] = {}
        self.specs = {}
        self.waiting: List[int] = []        # submitted, not admitted: FIFO
        self.inflight: set = set()
        self.step_end: Dict[int, float] = {}
        self.steps: List[StepRecord] = []
        self.tier = cfg["deployment"]["tier"]

    def submit(self, now: float) -> int:
        spec = self.traffic.next()
        rid = spec.index
        self.specs[rid] = spec
        self.logs[rid] = RequestLog(rid=rid, plen=len(spec.prompt),
                                    olen=spec.output_len, submit_t=now,
                                    chunk=self.mix.prefill_chunk)
        self.sched.submit(self.system.request(rid, spec.prompt,
                                              spec.output_len, self.tier))
        self.waiting.append(rid)
        self.inflight.add(rid)
        return rid

    def prefilling(self, step: int) -> bool:
        return any(r.admit_step is not None
                   and r.admit_step <= step < r.admit_step
                   + r.prefill_steps()
                   for r in (self.logs[i] for i in self.inflight))

    def turn(self, prev_end: float, traced: bool, submit: bool) -> float:
        sched, sp = self.sched, self.spans
        index = sched.steps
        t_a = time.perf_counter()
        with sp("admit"):
            q0 = len(sched.queue)
            sched.admit_pending()
            for _ in range(q0 - len(sched.queue)):
                self.logs[self.waiting.pop(0)].admit_step = index
        admit_s = time.perf_counter() - t_a
        kind = "mixed" if self.prefilling(index) else "decode"
        n_before = {k: len(v) for k, v in sched.step_seconds.items()}
        pre0 = self.system.prefill_tokens(sched)
        with sp(f"{kind}_step"):
            sched.step_once()
        end = time.perf_counter()
        grew = [k for k, v in sched.step_seconds.items()
                if len(v) > n_before[k]]
        if grew != [kind]:
            raise HarnessError(f"step {index} ran as {grew}, the harness "
                               f"expected a {kind} step")
        self.step_end[index] = end
        with sp("collect_retire"):
            done = [rid for rid in self.inflight if rid in sched.results]
            self.inflight.difference_update(done)
        if submit:
            with sp("client"):
                now = time.perf_counter()
                for _ in done:
                    self.submit(now)
        pre = self.system.prefill_tokens(sched) - pre0
        self.steps.append(StepRecord(
            index=index, kind=kind, loop_s=end - prev_end,
            step_s=sched.step_seconds[kind][-1], admit_s=admit_s,
            free_pages=self.system.free_pages(sched), prefill_tokens=pre,
            traced=traced))
        return end

    def ramp(self) -> None:
        """Set-up: every client sends its first request (cut short by the
        traffic, so that completions come spread), served until each has
        given its first token: the window opens on a loop in steady
        state, not on every client's prompt at once."""
        now = time.perf_counter()
        firsts = [self.logs[self.submit(now)] for _ in range(
            self.mix.clients)]
        prev = now
        while any(r.admit_step is None
                  or self.sched.steps <= r.token_step(0) for r in firsts):
            prev = self.turn(prev, False, submit=True)

    def run(self, seconds: float, stretch=None, stretch_at: float = 0.0):
        """Serve for ``seconds``, the profiled ``stretch`` (if any) from
        the first step of the mix's ``trace_kind`` that ends ``stretch_at``
        seconds in or later; returns (t0, first step, last step)."""
        t0 = time.perf_counter()
        first, prev = self.sched.steps, t0
        while True:
            if (stretch is not None and stretch.state == "idle"
                    and prev >= t0 + stretch_at and self.steps
                    and self.steps[-1].kind == self.mix.trace_kind):
                stretch.start()
            on = stretch is not None and stretch.state in ("warm", "on")
            prev = self.turn(prev, on, submit=True)
            if on:
                stretch.turned(self.steps[-1].index)
                if stretch.state == "done":
                    prev = time.perf_counter()
            if prev >= t0 + seconds:
                break
        if stretch is not None:
            stretch.stop()
        return t0, first, self.sched.steps - 1

    def drain(self, want, deadline_s: float) -> None:
        """Serve on without new requests until ``want()`` holds or the
        deadline passes."""
        t_end = time.perf_counter() + deadline_s
        prev = time.perf_counter()
        while self.inflight and not want() and prev < t_end:
            prev = self.turn(prev, False, submit=False)

    def finished(self) -> List[dict]:
        out = []
        for rid, log in self.logs.items():
            res = self.sched.results.get(rid)
            if res is None:
                continue
            served = [int(t) for t in res.tokens.reshape(-1)]
            if (len(served) != log.olen or log.admit_step is None
                    or res.ttft_steps != log.prefill_steps()):
                raise HarnessError(
                    f"request {rid}: {len(served)} of {log.olen} tokens, "
                    f"first after {res.ttft_steps} steps where the prefill "
                    f"takes {log.prefill_steps()}")
            out.append({"rid": rid, "prompt": self.specs[rid].prompt,
                        "served": served, "page_ids": [int(p) for p in res.page_ids]})
        return out


def warm_up(sched, system, mix, cfg) -> None:
    """One request of one prefill chunk and four tokens: a mixed step at
    the cell's chunk, the decode step's eager run and its capture."""
    import numpy as np
    prompt = (np.arange(mix.prefill_chunk) % cfg["vocab_size"]).astype(
        np.int32)
    sched.submit(system.request("warm-up", prompt, 4,
                                cfg["deployment"]["tier"]))
    while "warm-up" not in sched.results:
        sched.admit_pending()
        sched.step_once()


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cfg: dict, mix, *, seed: int, seconds: float, trace: bool,
             device, metric_names, checks: dict, t_start: float = T_PROCESS,
             control: bool = False) -> dict:
    """One run; returns the result object (without ``device``).  With
    ``control`` the reference at the next precision below the
    configuration's takes the program's place in the comparison (which
    must then come out not correct); the program's own numbers go to
    ``sample``."""
    import torch
    system = importlib.import_module(f"hbm_bench.{cfg['system']}")
    reference = importlib.import_module(
        f"hbm_bench.reference.{cfg['reference']}")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = system.program_params(cfg, seed, dev)
    sched = system.build(cfg, mix, params, dev)
    warm_up(sched, system, mix, cfg)
    _sync(dev)
    traffic = Traffic(mix, seed, cfg["vocab_size"])
    loop = ClosedLoop(sched, system, traffic, mix, cfg,
                      tracing.Spans(trace))
    loop.ramp()
    _sync(dev)
    stretch = tracing.Stretch(mix.trace_steps) if trace else None
    setup_s = time.time() - t_start
    t0, first, last = loop.run(seconds, stretch, stretch_at=0.4 * seconds)
    _sync(dev)
    bad_mods = forbidden_modules()
    if bad_mods:
        raise HarnessError(f"modules loaded in the run: {bad_mods}")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if stretch is not None:
        stretch.read()
    acc = account(list(loop.logs.values()), loop.step_end, first, last, t0)
    record = RunRecord(cfg=cfg, setup_s=setup_s,
                       steps=[s for s in loop.steps
                              if first <= s.index <= last],
                       account=acc, num_pages=system.num_pages(mix),
                       stretch=stretch.summary if stretch else None)
    values = {}
    for name in metric_names:
        v = M.read(name, record)
        if v is not None:
            values[name] = float(v)
    attempted = len(loop.logs)

    def enough():
        fin = [r for r in loop.logs.values() if r.rid in sched.results]
        return sum(r.olen for r in fin) >= mix.sample_tokens
    loop.drain(enough, 60.0)
    finished = loop.finished()
    for r in finished:
        r["place"] = system.placement(cfg, mix, r)
    usable = [r for r in finished if reference.usable(cfg, r, dev)]
    sample = compare.pick_sample(usable, seed, mix.sample_tokens,
                                 mix.sample_max)
    del loop, sched, params, system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, info = reference.check(cfg, seed, sample, dev, control=control)
    ok = bool(sample) and all(numbers[k] <= checks[k] for k in checks)
    # a closed loop refuses nothing: a request that cannot be admitted
    # waits, and one the program fails on fails the whole run
    out = {"correct": ok, "attempted": attempted, "failed": 0,
           "metrics": values, "memory_peak_bytes": int(peak),
           "finished": len(finished), "sample": info,
           "window": {"seconds": acc.seconds, "steps": acc.steps,
                      "mixed_steps": sum(s.kind == "mixed"
                                         for s in record.steps),
                      "output_tokens": acc.output_tokens,
                      "first_tokens": len(acc.ttft_s)}}
    if trace and stretch is not None and stretch.summary is not None:
        out["busy_s"] = stretch.summary["busy_s"]
        out["window_s"] = stretch.summary["window_s"]
        out["breakdown"] = tracing.breakdown(stretch.summary)
    out["checks"] = {k: {"value": numbers[k], "limit": checks[k]}
                     for k in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # every build cache at a fixed place inside the checkout (the
    # program builds its kernels into build/kernels there itself)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
        found = Path(repro_torch.__file__).resolve()
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    if ROOT / "src" not in found.parents:
        print(f"repro_torch loaded from {found}, not from this checkout",
              file=sys.stderr)
        return 2
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = load_mix(cell["traffic"])
    group = "per_layer" if args.trace else "end_to_end"
    names = [m["name"] for m in spec[group]
             if "workloads" not in m or cell["name"] in m["workloads"]]
    try:
        out = run_cell(cfg, mix, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device="cuda",
                       metric_names=names, checks=cfg["checks"])
    except HarnessError as e:
        print(f"run failed: {e}", file=sys.stderr)
        return 1
    units = {m["name"]: m["unit"] for m in spec[group]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in out["metrics"].items()},
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": int(cell["chips"]),
                       "memory_peak_bytes": out["memory_peak_bytes"]},
            "finished": out["finished"],
            "sample": out["sample"], "window": out["window"]}
    if args.trace:
        line["device"]["busy_s"] = out.get("busy_s", 0.0)
        line["device"]["window_s"] = out.get("window_s", 0.0)
        if "breakdown" in out:
            line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
