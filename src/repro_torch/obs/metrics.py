"""In-step metrics: per-shard counters kept beside the serving state,
plus host-side latency histograms (port of :mod:`repro.obs.metrics`).

The counters live as ONE ``(n_shards, N)`` int32 tensor of the
scheduler's state.  Each serving step adds its deltas, computed with a
few torch operations from the step's lane masks and cursors (active /
decode lanes, cursors, migration lanes); the port's scheduler keeps the
tensor on the host, where it drives the step, so the counters cost no
device work and no sync.

Counter units are discrete events (tokens, cache slots, logical pages),
converted to bytes on the host with the pool's static K/V page geometry.
``kv_pages_read`` counts *useful* traffic: every active lane reads its
full page table once per step; inactive lanes' scratch reads are left
out on purpose, so joules/token prices the work tenants bought.

Host-side, the registry also keeps a bounded ring of per-step wall
times for the p50/p95/p99 step-latency report.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.energy import DEFAULT_ENERGY_MODEL, EnergyModel

# Donated-counter layout: one row per shard, one column per name, in
# this order.  Appending is backward-compatible (the state leaf is
# rebuilt per scheduler); reordering is not.
STEP_COUNTERS = (
    "tokens_decoded",     # decode lanes that sampled a token this step
    "prefill_tokens",     # prompt tokens consumed by prefilling lanes
    "kv_slots_written",   # cache slots written (COW write floor applied)
    "kv_pages_read",      # (active lane, logical page) reads via the
                          # page table -- the paged-attention gather
    "pages_migrated",     # self-healing page copies staged this step
)
_IDX = {name: i for i, name in enumerate(STEP_COUNTERS)}
N_STEP_COUNTERS = len(STEP_COUNTERS)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs of one scheduler.

    ``enabled=False`` removes the counter tensor, the event
    trace and the step timer entirely -- the metrics-off baseline the
    launch-budget and overhead tests compare against.
    """

    enabled: bool = True
    trace_capacity: int = 4096        # event ring entries kept
    latency_capacity: int = 4096      # step wall-times kept
    energy: EnergyModel = DEFAULT_ENERGY_MODEL


def init_step_counters(n_shards: int, device=None) -> torch.Tensor:
    """The ``(n_shards, N_STEP_COUNTERS)`` int32 counter tensor."""
    return torch.zeros((n_shards, N_STEP_COUNTERS), dtype=torch.int32,
                       device=device)


def step_counter_delta(*, act, dec, cursor, plen, wstart, chunk: int,
                       n_logical_pages: int, mig_src,
                       scratch_id: int) -> torch.Tensor:
    """One shard's per-step counter increments (torch, on the state's
    device).

    All inputs are the *pre-step* values the step holds; the result is a
    length-``N_STEP_COUNTERS`` int32 vector.
    Write accounting mirrors the paged write path exactly: decode lanes
    write one slot at ``qpos`` (always at/above the COW floor), prefill
    lanes write their consumed chunk clipped below by ``wstart`` (rows
    of a shared prefix are mapped read-only and never written).
    """
    pre = act & ~dec
    end = torch.minimum(cursor + chunk, plen)
    consumed = torch.where(pre, end - cursor, 0)
    written = torch.where(
        pre, torch.clamp_min(end - torch.maximum(cursor, wstart), 0), 0)
    decoded = (act & dec).to(torch.int32)
    return torch.stack([
        decoded.sum(),
        consumed.sum(),
        decoded.sum() + written.sum(),
        act.to(torch.int32).sum() * int(n_logical_pages),
        (mig_src != scratch_id).to(torch.int32).sum(),
    ]).to(torch.int32)


class MetricsRegistry:
    """Host half of the in-step metrics: static byte geometry, the
    cumulative-counter reader, and the step-latency ring.

    The device half is :func:`step_counter_delta` inside the serving
    step; this class never touches the device during serving -- it
    reads the counter tensor once per ``stats()`` call.
    """

    def __init__(self, n_shards: int, pool, config: ObsConfig, *,
                 kv_page_bytes: Optional[int] = None,
                 kv_slot_bytes: Optional[int] = None,
                 layouts: Optional[Sequence[str]] = None):
        self.n_shards = int(n_shards)
        self.config = config
        # Which cache layouts this scheduler's counters price: the
        # paged route tags "full"/"window", the state-arena route
        # whatever mix its family carries ("full"/"cross"/"state").
        self.layouts = tuple(layouts) if layouts is not None else None
        if pool is not None:
            # Static K/V payload geometry (bytes): what one page-table
            # read and one written cache slot move, over every k/v leaf
            # & layer (``pos`` bookkeeping words excluded -- they are
            # not payload).
            self.kv_page_bytes = 4 * sum(
                leaf.n_layers * leaf.page_words
                for leaf in pool.leaves if leaf.which in ("k", "v"))
            self.kv_slot_bytes = 4 * sum(
                leaf.n_layers * leaf.wps
                for leaf in pool.leaves if leaf.which in ("k", "v"))
        else:
            # Pool-less (state-arena) route: the scheduler supplies its
            # own static geometry -- ``kv_page_bytes`` is one lane's
            # whole per-slot cache payload (read every step),
            # ``kv_slot_bytes`` one lane's per-step write payload.
            self.kv_page_bytes = int(kv_page_bytes or 0)
            self.kv_slot_bytes = int(kv_slot_bytes or 0)
        cap = max(int(config.latency_capacity), 1)
        self._lat = np.zeros(cap, np.float64)
        self._lat_n = 0               # total recorded (ring may wrap)
        self.wall_seconds = 0.0

    # ---- latency ---------------------------------------------------------
    def record_step(self, seconds: float) -> None:
        self._lat[self._lat_n % len(self._lat)] = seconds
        self._lat_n += 1
        self.wall_seconds += seconds

    def latency(self) -> Dict[str, float]:
        n = min(self._lat_n, len(self._lat))
        if n == 0:
            return {"count": 0}
        w = self._lat[:n]
        p50, p95, p99 = np.percentile(w, [50, 95, 99])
        return {"count": self._lat_n, "mean_s": float(w.mean()),
                "p50_s": float(p50), "p95_s": float(p95),
                "p99_s": float(p99)}

    # ---- counters --------------------------------------------------------
    def counters_np(self, state) -> np.ndarray:
        """Cumulative ``(n_shards, N)`` counters off the state (one
        device->host read; no per-step sync)."""
        return state["mtr"].cpu().numpy().astype(np.int64)

    def shard_bytes_moved(self, counters: np.ndarray) -> np.ndarray:
        """Per-shard K/V bytes moved (read + written) from the
        discrete-unit counters and the static page geometry."""
        return (counters[:, _IDX["kv_pages_read"]] * self.kv_page_bytes
                + counters[:, _IDX["kv_slots_written"]]
                * self.kv_slot_bytes)

    def totals(self, state) -> Dict[str, int]:
        """Fleet-total counters plus derived byte totals."""
        c = self.counters_np(state)
        out = {name: int(c[:, i].sum())
               for i, name in enumerate(STEP_COUNTERS)}
        out["kv_bytes_read"] = int(
            (c[:, _IDX["kv_pages_read"]] * self.kv_page_bytes).sum())
        out["kv_bytes_written"] = int(
            (c[:, _IDX["kv_slots_written"]] * self.kv_slot_bytes).sum())
        out["kv_bytes_moved"] = (out["kv_bytes_read"]
                                 + out["kv_bytes_written"])
        return out

    # ---- energy ----------------------------------------------------------
    def energy(self, state,
               voltages: Sequence[float]) -> Dict[str, Any]:
        """Joules/token and $/1M-tokens per shard and fleet-wide.

        ``voltages`` is each shard's operating rail voltage (shards of
        an unplaced/clean scheduler price at nominal).  Every shard is
        charged the full recorded wall time for its static watts.
        """
        em = self.config.energy
        c = self.counters_np(state)
        bytes_k = self.shard_bytes_moved(c)
        toks_k = c[:, _IDX["tokens_decoded"]]
        shards = []
        joules_total = 0.0
        for k in range(self.n_shards):
            rep = em.report(seconds=self.wall_seconds,
                            bytes_moved=float(bytes_k[k]),
                            tokens=max(int(toks_k[k]), 1),
                            v=float(voltages[k]))
            rep["shard"] = k
            rep["tokens"] = int(toks_k[k])
            rep["kv_bytes_moved"] = int(bytes_k[k])
            shards.append(rep)
            joules_total += rep["joules"]
        tokens_total = int(toks_k.sum())
        jpt = joules_total / max(tokens_total, 1)
        return {
            "shards": shards,
            "wall_seconds": self.wall_seconds,
            "tokens": tokens_total,
            "kv_bytes_moved": int(bytes_k.sum()),
            "joules": joules_total,
            "joules_per_token": jpt,
            "usd_per_mtok": em.usd_per_mtok(jpt),
            "tokens_per_joule": (tokens_total / joules_total
                                 if joules_total > 0 else 0.0),
        }

    def snapshot(self, state, voltages: Optional[Sequence[float]] = None,
                 ) -> Dict[str, Any]:
        """Counters + latency (+ energy when voltages are supplied)."""
        c = self.counters_np(state)
        out: Dict[str, Any] = {
            "counters": {name: c[:, i].tolist()
                         for i, name in enumerate(STEP_COUNTERS)},
            "totals": self.totals(state),
            "step_latency": self.latency(),
        }
        if self.layouts is not None:
            out["cache_layouts"] = list(self.layouts)
        if voltages is not None:
            out["energy"] = self.energy(state, voltages)
        return out
