"""Exporters: Prometheus text format and JSON snapshots of one
scheduler's observability plane, plus the JSONL event-trace dump (port
of :mod:`repro.obs.export`, line for line: the same names, labels and
formats, over the port's scheduler ``stats``, :mod:`repro_torch.obs.
metrics` and :mod:`repro_torch.obs.trace`).  ``stats["shards"]`` has one
entry per shard of the scheduler's mesh.

Pull-based and allocation-free on the serving path: each export reads
the donated counter leaf once, walks the host-side gauges, and
formats.  Metric names are stable (see the README "Observability"
reference table); per-shard series carry a ``shard`` label, event
totals a ``kind`` label.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

_PREFIX = "repro"

# HELP strings for the Prometheus exposition (name -> help, type).
_COUNTER_HELP = {
    "tokens_decoded": "Decode-lane tokens sampled inside the donated step",
    "prefill_tokens": "Prompt tokens consumed by chunked prefill",
    "kv_slots_written": "KV cache slots written (COW write floor applied)",
    "kv_pages_read": "Logical-page reads through the page tables",
    "pages_migrated": "Self-healing page migrations applied in-step",
}
_HEAL_GAUGES = ("corrected", "uncorrectable", "migrations",
                "quarantined_pages", "quarantined_blocks",
                "setpoint_escalations")


def _fmt(name: str, value, labels: Dict[str, Any] = None) -> str:
    lab = ""
    if labels:
        inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
        lab = "{" + inner + "}"
    if isinstance(value, float):
        return f"{_PREFIX}_{name}{lab} {value:.6g}"
    return f"{_PREFIX}_{name}{lab} {value}"


def _head(lines: List[str], name: str, help_: str, type_: str) -> None:
    lines.append(f"# HELP {_PREFIX}_{name} {help_}")
    lines.append(f"# TYPE {_PREFIX}_{name} {type_}")


def shard_voltages(sched) -> List[float]:
    """Each shard's pricing voltage: the operating rail voltage for
    placed (undervolted) schedulers, nominal for clean ones."""
    return list(sched.pricing_voltages)


def json_snapshot(sched) -> Dict[str, Any]:
    """One JSON-serializable snapshot: scheduler stats + counters +
    latency + energy + event counts."""
    out: Dict[str, Any] = {"stats": _plain(sched.stats)}
    if sched.metrics is not None:
        out["metrics"] = _plain(sched.metrics.snapshot(
            sched.state, voltages=shard_voltages(sched)))
    if sched.trace is not None:
        out["events"] = {"counts": dict(sched.trace.counts),
                         "emitted": sched.trace.emitted,
                         "in_ring": len(sched.trace)}
    return out


def _plain(x):
    """Coerce numpy scalars/arrays into plain JSON types."""
    import numpy as np
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def prometheus_text(sched) -> str:
    """Prometheus exposition-format snapshot of one scheduler."""
    st = sched.stats
    lines: List[str] = []

    # ---- gauges: per-shard operating point ---------------------------
    _head(lines, "voltage", "Shard operating rail voltage (V)", "gauge")
    for sh in st["shards"]:
        lines.append(_fmt("voltage", float(sh["voltage"]),
                          {"shard": sh["shard"]}))
    _head(lines, "free_pages", "Free KV pool pages", "gauge")
    for sh in st["shards"]:
        lines.append(_fmt("free_pages", int(sh["free_pages"]),
                          {"shard": sh["shard"]}))
    _head(lines, "active_requests", "Live requests on the shard", "gauge")
    for sh in st["shards"]:
        lines.append(_fmt("active_requests", int(sh["active"]),
                          {"shard": sh["shard"]}))
    for sh in st["shards"]:
        if sh.get("setpoint") is not None:
            _head(lines, "governor_setpoint",
                  "Shard governor walk target", "gauge")
            break
    for sh in st["shards"]:
        if sh.get("setpoint") is not None:
            lines.append(_fmt("governor_setpoint", float(sh["setpoint"]),
                              {"shard": sh["shard"]}))
    if "corrected" in st:                     # self-healing telemetry
        for key in _HEAL_GAUGES:
            _head(lines, f"heal_{key}",
                  f"Self-healing telemetry: {key}", "gauge")
            for sh in st["shards"]:
                lines.append(_fmt(f"heal_{key}", int(sh.get(key, 0)),
                                  {"shard": sh["shard"]}))
    _head(lines, "decode_traces",
          "Compiled decode traces (the ONE-step contract)", "gauge")
    lines.append(_fmt("decode_traces", int(st["decode_traces"])))

    # ---- counters: the donated in-step metrics -----------------------
    if sched.metrics is not None:
        snap = sched.metrics.snapshot(sched.state,
                                      voltages=shard_voltages(sched))
        for name, per_shard in snap["counters"].items():
            _head(lines, f"{name}_total",
                  _COUNTER_HELP.get(name, name), "counter")
            for k, v in enumerate(per_shard):
                lines.append(_fmt(f"{name}_total", int(v), {"shard": k}))
        for name in ("kv_bytes_read", "kv_bytes_written"):
            _head(lines, f"{name}_total",
                  "KV payload bytes via the page tables", "counter")
            lines.append(_fmt(f"{name}_total",
                              int(snap["totals"][name])))
        lat = snap["step_latency"]
        if lat.get("count"):
            _head(lines, "step_latency_seconds",
                  "Donated-step wall time", "summary")
            for q, key in (("0.5", "p50_s"), ("0.95", "p95_s"),
                           ("0.99", "p99_s")):
                lines.append(_fmt("step_latency_seconds", float(lat[key]),
                                  {"quantile": q}))
            lines.append(_fmt("step_latency_seconds_count",
                              int(lat["count"])))
        en = snap["energy"]
        _head(lines, "joules_per_token",
              "HBM energy per decoded token", "gauge")
        for rep in en["shards"]:
            lines.append(_fmt("joules_per_token",
                              float(rep["joules_per_token"]),
                              {"shard": rep["shard"]}))
        _head(lines, "usd_per_mtok",
              "Energy cost per 1M decoded tokens (USD)", "gauge")
        for rep in en["shards"]:
            lines.append(_fmt("usd_per_mtok", float(rep["usd_per_mtok"]),
                              {"shard": rep["shard"]}))
        _head(lines, "fleet_joules_per_token",
              "Fleet HBM energy per decoded token", "gauge")
        lines.append(_fmt("fleet_joules_per_token",
                          float(en["joules_per_token"])))
        _head(lines, "fleet_usd_per_mtok",
              "Fleet energy cost per 1M tokens (USD)", "gauge")
        lines.append(_fmt("fleet_usd_per_mtok",
                          float(en["usd_per_mtok"])))

    # ---- event totals ------------------------------------------------
    if sched.trace is not None:
        _head(lines, "events_total",
              "Scheduler control-plane events by kind", "counter")
        for kind, n in sorted(sched.trace.counts.items()):
            lines.append(_fmt("events_total", int(n), {"kind": kind}))
    return "\n".join(lines) + "\n"


def write_trace_jsonl(sched, path: str) -> int:
    """Dump the scheduler's event ring as JSON Lines; returns the
    number of events written (0 when tracing is disabled)."""
    if sched.trace is None:
        return 0
    return sched.trace.to_jsonl(path)
