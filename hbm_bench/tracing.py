"""The harness's host spans and the profiled stretch of a traced run.

Spans are ``record_function`` ranges opened by the harness around its
calls into the program: ``admit``, ``mixed_step``, ``decode_step``,
``collect_retire`` and ``client``.  In a traced run one stretch of the
window runs under ``torch.profiler``: one warm-up turn of the serving
loop (the profiler's own first-step cost), then ``trace_steps`` turns
inside a ``stretch`` span; the stretch opens at the first turn after a
step of the mix's ``trace_kind``.  Its chrome trace gives the device
operations inside that span, the union of their intervals (the busy time), and the
device's idle time, split over the host spans it overlaps.  Outside a
traced run the spans are not opened at all.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional

SPANS = ("admit", "mixed_step", "decode_step", "collect_retire", "client")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


class Stretch:
    """One profiled stretch of the window: a warm-up turn, then
    ``steps`` turns inside the ``stretch`` span."""

    def __init__(self, steps: int):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.want = int(steps)
        self.steps: List[int] = []      # indices of the turns in the span
        self.state = "idle"             # idle | warm | on | done
        self.summary: Optional[dict] = None
        self._span = None

    def start(self):
        self.prof.start()
        self.state = "warm"

    def turned(self, index: int) -> None:
        """Called after each turn the profiler saw."""
        from torch.profiler import record_function
        if self.state == "warm":
            self._span = record_function("stretch")
            self._span.__enter__()
            self.state = "on"
            return
        self.steps.append(index)
        if len(self.steps) >= self.want:
            self.stop()

    def stop(self):
        import torch
        if self.state not in ("warm", "on"):
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        if self._span is not None:
            self._span.__exit__(None, None, None)
        self.prof.stop()
        self.state = "done"

    def read(self) -> None:
        """Summarize the stopped stretch (after the window has closed)."""
        if self.state != "done" or self.summary is not None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = summarize(events)
        self.summary["steps"] = list(self.steps)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events) -> dict:
    """Busy and window seconds, device time by operation, idle time by
    host span, and every device operation's (name, seconds), from a
    chrome trace's events (times in us).  The window is the ``stretch``
    span, or without one from the first harness span's start to the last
    one's end."""
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    bounds = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in marks if e["name"] == "stretch"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"]) for e in marks if e["name"] in SPANS)
    if bounds:
        spans = [s for s in spans
                 if s[0] >= bounds[0][0] and s[1] <= bounds[0][1]]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
            e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if not spans:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": [], "by_op": {},
                "idle_by_span": {}, "step_spans": []}
    w0, w1 = bounds[0] if bounds else (spans[0][0],
                                        max(s[1] for s in spans))
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in ops
              if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _ in inside])
    by_op: Dict[str, float] = defaultdict(float)
    for a, b, n in inside:
        by_op[n] += (b - a) / 1e6
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    starts = [s[0] for s in spans]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        # the gap split over the host spans it overlaps; what is left is
        # the harness's own code between spans
        covered = 0.0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(spans) and spans[i][0] < g1:
            a, b, name = spans[i]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                idle[name] += part / 1e6
                covered += part
            i += 1
        if g1 - g0 - covered > 0:
            idle["harness"] += (g1 - g0 - covered) / 1e6
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            # (name, start us, seconds) of every device operation
            "ops": [(n, a, (b - a) / 1e6) for a, b, n in inside],
            "by_op": dict(by_op), "idle_by_span": dict(idle),
            # (start us, end us, kind) of every step, in order
            "step_spans": [(a, b, n[:-len("_step")]) for a, b, n in spans
                           if n in ("mixed_step", "decode_step")]}


def breakdown(summary: dict) -> dict:
    """The ten operations that took the most device time, and the ten
    host spans in which the device sat idle longest."""
    top = sorted(summary["by_op"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in gaps[:10]]}
