"""Algorithm 1 of the paper: reliability assessment via sequential access.

Port of :mod:`repro.core.reliability`.  Writes a data pattern (all 1s or
all 0s) through a pseudo-channel's address space, reads it back under
the undervolt fault model and counts mismatched bits, over the sweep from
V_nom to V_critical in 10 mV steps, per PC, with batch repetition (the
stuck-at faults are deterministic per map seed, so batches agree unless
an optional transient rate adds run-to-run noise).

On the card a whole VCU128 PC is one test: 2**26 words through one K5
launch (:func:`repro_torch.kernels.bitflip.ops.inject_u32`), then a
popcount of ``written ^ read`` summed in int64 on the device (at the
deepest voltages the count passes 2**31).  :func:`sweep` with
``device="cuda"`` is the port's Algorithm 1 entry point.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import hashing as H
from repro_torch.core.faultmap import FaultMap
from repro_torch.core.tradeoff import voltage_grid
from repro_torch.kernels.bitflip import ops as bitflip_ops
from repro_torch.kernels.ecc.ref import popcount32

ALL_ONES = 0xFFFFFFFF
ALL_ZEROS = 0x00000000

STREAM_TRANSIENT = 0x68E31DA4


@dataclasses.dataclass(frozen=True)
class TestResult:
    voltage: float
    pc: int
    pattern: int
    mem_words: int
    fault_counts: tuple  # one entry per batch


def pattern_words(pattern: int, mem_words: int, device) -> torch.Tensor:
    """The written array: ``mem_words`` int32 words holding ``pattern``."""
    return torch.full((mem_words,), int(H.as_i32(torch.tensor(pattern))),
                      dtype=torch.int32, device=device)


def count_flips(written: torch.Tensor, read: torch.Tensor) -> torch.Tensor:
    """Mismatched bits of two int32 word arrays: a SWAR popcount of
    ``written ^ read``, summed in int64 on their device (0-d tensor)."""
    return popcount32(H.as_u64(written ^ read)).sum(dtype=torch.int64)


def _transient_flips(mem_words: int, base: int, rate: float, seed: int,
                     batch: int, device) -> torch.Tensor:
    """Per-batch transient upsets: a word is hit with probability
    min(1, 32 rate) and a hit flips one hashed bit (int32 xor mask)."""
    q = H.rate_to_u32_threshold(min(1.0, 32.0 * rate))
    wid = (torch.arange(mem_words, dtype=torch.int64, device=device)
           + base) & H.MASK
    u = H.hash_stream(seed + batch + 1, STREAM_TRANSIENT, wid)
    pos = H.hash_stream(seed ^ 0x5BD1E995, STREAM_TRANSIENT, wid) & 31
    flip = torch.where(u < q, torch.ones_like(pos) << pos,
                       torch.zeros((), dtype=torch.int64, device=device))
    return H.as_i32(flip)


def _sync(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run_pc_test(faultmap: FaultMap, voltage: float, pc: int, *,
                mem_words: int, pattern: int = ALL_ZEROS,
                batch_size: int = 1, method: str = "bitwise",
                transient_rate: float = 0.0, seed: int = 0,
                use_ref: bool = False, device="cuda",
                written: Optional[torch.Tensor] = None,
                timings: Optional[Dict[str, float]] = None) -> TestResult:
    """Algorithm 1 on one pseudo-channel (``mem_words`` from its base).

    ``written``: the pattern array to reuse (as :func:`sweep` does), else
    one is allocated; the injection returns a new tensor and never writes
    into it.  ``timings``, when given, accumulates host seconds (device
    synchronised) under ``inject_<method>_s`` and ``count_s`` and the
    number of injections under ``tests_<method>``."""
    dev = resolve_device(device)
    thr = faultmap.thresholds(voltage, pc)
    if method == "auto":
        method = bitflip_ops.pick_method(thr)
    base = pc * (faultmap.geometry.bytes_per_pc // 4)
    if written is None:
        written = pattern_words(pattern, mem_words, dev)
    if tuple(written.shape) != (mem_words,) or written.device != dev:
        raise ValueError(f"written array {tuple(written.shape)} on "
                         f"{written.device}, expected ({mem_words},) on {dev}")
    counts: List[int] = []
    for b in range(batch_size):
        t0 = _sync(dev) if timings is not None else 0.0
        read = bitflip_ops.inject_u32(
            written, thresholds=thr, seed=faultmap.seed, base_word=base,
            method=method, use_ref=use_ref)
        if transient_rate > 0.0:
            read = read ^ _transient_flips(mem_words, base, transient_rate,
                                           seed, b, dev)
        t1 = _sync(dev) if timings is not None else 0.0
        counts.append(int(count_flips(written, read)))
        if timings is not None:
            t2 = _sync(dev)
            for key, val in ((f"inject_{method}_s", t1 - t0),
                             ("count_s", t2 - t1), (f"tests_{method}", 1)):
                timings[key] = timings.get(key, 0) + val
    return TestResult(voltage=float(voltage), pc=pc, pattern=pattern,
                      mem_words=mem_words, fault_counts=tuple(counts))


def sweep(faultmap: FaultMap, *, pcs: Sequence[int], mem_words: int,
          patterns: Sequence[int] = (ALL_ZEROS, ALL_ONES),
          v_grid: Optional[Sequence[float]] = None,
          batch_size: int = 1, method: str = "bitwise",
          use_ref: bool = False, device="cuda",
          timings: Optional[Dict[str, float]] = None,
          ) -> Dict[float, List[TestResult]]:
    """The paper's full sweep: V_nom -> V_critical, 10 mV steps, every PC
    of ``pcs`` under every pattern; each pattern array is allocated once
    and reused by every test."""
    dev = resolve_device(device)
    grid = list(v_grid if v_grid is not None else voltage_grid())
    written = {p: pattern_words(p, mem_words, dev) for p in patterns}
    out: Dict[float, List[TestResult]] = {}
    for v in grid:
        out[float(v)] = [
            run_pc_test(faultmap, float(v), pc, mem_words=mem_words,
                        pattern=p, batch_size=batch_size, method=method,
                        use_ref=use_ref, device=dev, written=written[p],
                        timings=timings)
            for pc in pcs for p in patterns
        ]
    return out


def observed_rate(result: TestResult) -> float:
    """Observed per-bit flip rate for one test."""
    mean = float(np.mean(result.fault_counts))
    return mean / (result.mem_words * 32)
