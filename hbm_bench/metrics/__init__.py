"""Metric readers: one file a metric, ``<name>.py``, found by the
metric's name in ``BENCHMARK.json``.  A name ``<reader>.<qualifier>``
without a file of its own reads ``<reader>.py``: one quantity split by
the end-to-end metric it moves in different cells (a later prefill
cell's ``mfu.prefill`` beside ``mfu``).  Each defines ``read(run)`` over a
:class:`hbm_bench.run.RunRecord` and returns a number, or None when the
run holds nothing for it to read (the harness then leaves the metric
out of the line)."""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader_file(name: str) -> Path:
    own = HERE / f"{name}.py"
    return own if own.exists() else HERE / f"{name.split('.')[0]}.py"


def read(name: str, run):
    path = reader_file(name)
    spec = importlib.util.spec_from_file_location(
        f"hbm_bench.metrics._{path.stem.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)
