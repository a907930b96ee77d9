#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the root of a checkout.  It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel), then

  1. kernel phases, at the shapes of the main path (llama3.2-3b, batch 4,
     max_len 1024, KV cache in a 16-PC undervolted domain), at voltages
     where every layer slice holds thousands of faulted words: the arena
     bitflip kernel (word and bitwise) and the arena ECC kernel against
     their plain PyTorch versions (bits and counts equal), the faulty
     decode-attention kernel against its plain version (injection on/off,
     ECC on/off, bitwise; element-wise bf16 tolerance 1e-2 + 1e-2*|ref|
     over finite outputs, NaN/Inf patterns equal, injected output unlike
     the uninjected one), read-path injection against attention over
     the write-path-corrupted cache (bits equal) and the decode kernel at
     batch 4 against each row launched alone (bits equal, injection on
     and off; the split ring reads only the ring length and the tile);
     each timed with CUDA events beside its bound, with its split count
     and block count printed;
  2. a small-input check: reduced llama3.2-3b in float32 serves the same
     greedy tokens on the card (kernels) and on the CPU (plain versions);
  3. serving phases through ``generate()``: full-width llama3.2-3b (28
     layers, bf16, weights from a seeded generator): clean, 0.98 V (must
     equal clean), 0.91 V read vs write and 0.91 V with ECC read vs write
     (must be equal; the timed phases), 0.975 V (the K3 route with no
     fault), 0.88 V read vs write, 0.875 V with ECC read vs write
     and 0.8775 V with ECC read vs write (each pair equal, and unlike the
     0.975 V tokens), with the kernels' launch counts;
  4. the paged decode-attention kernel (K4) at the scheduler's shape (4
     slots x 128 shuffled pages of 8 slots in a period-stacked pool)
     against its plain version (same tolerance), against K3 over the
     same words gathered into ring order (bits equal, injection on and
     off) and, with ECC, its telemetry counts (equal); timed beside its
     bound and SDPA, and at half its split size (the choice of
     faulty.SPLIT_SLOTS);
  5. serving phases through ``ContinuousBatchingScheduler``: the same
     full-width model, 4 slots, pages of 8 slots, prefill chunks of 64,
     a pool for about 5 requests, 8 requests (prompts 96..384, 16..48 new
     tokens): clean (tiers cheap/critical, two requests sharing a
     256-token prefix) == clean ``generate()`` at the page tile; 0.91 V
     read (timed), 0.88 V read / write and 0.875 V ECC read / write, each
     request == its solo ``generate(kv_placement=...)`` replay, read ==
     write, unlike a 0.975 V run; K4 launched 28 times per step;
  6. the per-segment kernels at the paper's memSize (one whole 256 MiB
     VCU128 pseudo-channel, 2**26 words): K5 (word at 0.88 V, bitwise at
     0.86 V) and K6 (0.875 V, 0.91 V) against their plain versions (bits
     and counts), K5 against K1 over the same PC laid out as arena blocks,
     a run wrapping past word 2**32 and an unaligned ECC run whose
     zero-padded tail holds uncorrectable codewords; timed;
  7. the paper's Algorithm 1 sweep through ``reliability.sweep``: 40
     voltages x 32 PCs x 2 patterns x 2**26 words (2,560 K5 launches),
     held to the plain version's counts, zero flips in the guardband and
     the reference's own Algorithm 1 assertions, with its time split
     between K5 and counting;
  8. the segments engine (one K5/K6 launch per segment) against the arena
     engine (one K1/K2 launch) over the generate() cell's 448 MiB KV cache
     (bits and uncorrectable counts equal);
  9. ``generate()`` under the admission governor (rate mode): the admitted
     voltage lies below the guardband and the tokens equal the fixed-
     voltage run at that voltage;
 10. prefill flash attention (K7) against its plain version at the
     recurrentgemma-9b cell's shape (q (4, 16, 2560, 256), one KV head,
     causal, window 2048, bf16, the wgmma variant; 1e-2 + 1e-2*|ref|),
     at the state-arena admission shape (B = 1, S = 1024) and at S = 1024
     in float32 without a window (the tf32x3 variant; 1e-5 + 1e-5*|ref|),
     each launch's variant checked, batch rows at B = 1 equal to the same
     rows at B = 4 on bits; timed on the device (queued) and at the eager
     host pace beside its bound, SDPA over the band, causal SDPA and, at
     the cell and at the f32 shape, its SIMT variant; the RG-LRU scan (K8)
     at (4, 2560, 4096) and at S = 1 with a nonzero h0, both entries --
     the scan (a, b given) and the gated one (the model's gate math fused
     in, bf16 y) -- against their plain versions (1e-5 + 1e-5*|ref|),
     rows 0 and 3 at B = 1 equal to the same rows at B = 4 on bits, the
     gated entry's h_last written over h0 equal to a fresh one, timed
     queued and at the host pace, the gated entry beside the gate ops and
     the scan entry it replaces (and faster than them);
 11. reduced recurrentgemma-9b in float32: prefill logits on the card
     (K7 all tf32x3, K8 all gated) within 1e-4 of the CPU's and greedy
     tokens equal (clean, 0.875 V write, 0.868 V ECC write);
 12. full-width recurrentgemma-9b (38 layers, bf16, weights from a seeded
     generator, the llama weights freed first) through ``generate()``:
     batch 4, a 2560-token prompt (past the local window), 32 new tokens,
     the cache in the 16-PC domain: clean, 0.98 V (must equal clean),
     0.975 V (the no-fault reference), 0.91 V write, 0.88 V write and
     rewrite (must be equal) and 0.875 V ECC write; K7 launched 12 times
     per prefill, all through its wgmma variant, K8 26 times per prefill
     and per decode step, all through its gated entry, K1/K2 once per
     undervolted write request;
 13. the same model through ``ContinuousBatchingScheduler``, which must
     give the state-arena scheduler: 3 slots, 6 requests (prompts
     128..1024, 8..24 new tokens), clean and 0.88 V write, each request
     == its solo ``generate()`` replay, K8 26 times per step and per
     admission (all gated), every K7 admission launch through the wgmma
     variant.

Phases 6-8 run after the K4 phase, 9 after the generate() phases, 10
and 11 after 8, 12 and 13 last.
Any mismatch raises; nothing is caught except the one CapacityError a
critical request must raise on an undervolted full-width pool (see
scheduler_phases).  The last three lines are the
kernel JSON line, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  It needs no network and one card; it
exits non-zero without a CUDA device or without the port's sources.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 at
# 3.35 TB/s and 67 TFLOP/s float32 outside the tensor cores.  Integer and
# logic operations are bounded by the issue rate: an SM issues at most 4
# warp instructions (128 lane operations) per clock, which is the FP32
# lane rate, 67e12 / 2 (the data sheet counts an FMA as two flops).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT_OPS_PER_S = 67e12 / 2
# bf16 on the tensor cores (dense): the bound of an attention over bf16
# inputs, whatever units the kernel uses.
BF16_FLOPS_PER_S = 989e12
# TF32 on the tensor cores (dense): the bound of K7's 3xTF32 variant, which
# does three TF32 products for each float32 one.
TF32_FLOPS_PER_S = 494.7e12

# Integer operations per word, counted from csrc/fault_masks.cuh: a
# hash_stream is 9 (input xor, 3 shifts, 3 xors, 2 multiplies); the word
# path runs 5 hashes plus compares, selects, shifts and the final
# (x | m01) & ~(m10 & ~m01), about 60 in all; the bitwise path adds 20
# planes per direction at about 17 operations each (696); ECC runs the
# word masks of both words, two popcounts, a second weak-row hash and the
# parity hash per codeword (about 78 per word).  K3 adds about 6 to form
# each word's leaf offset.  These source-level counts are the bounds'
# fallback; sass_per_word() replaces them by the compiled code's count
# (csrc/sass_probe.cu) where cuobjdump is at hand.
OPS_PER_WORD = {"word": 60, "bitwise": 696, "ecc": 78}
K3_ADDR_OPS = 6

B, PROMPT, MAX_LEN, NEW = 4, 128, 1024, 32
# Serving timings run at 0.91 V, where the 16 most reliable PCs hold only a
# few faulted words in the whole cache.  The checks that must see faults
# run where every layer slice holds thousands of faulted words and most
# attention outputs stay finite: 0.88 V (word and bitwise masks) and
# 0.875 V with ECC (uncorrectable codewords in every layer).
V_FAULTY = 0.91
V_DENSE = 0.88
V_DENSE_ECC = 0.875
# At 0.88 V and 0.875 V ECC nearly every decoded token comes from all-NaN
# logits; 0.8775 V with ECC has fewer uncorrectable codewords in the live
# cache, so ECC read == write is also held on tokens that are mostly not.
V_MID_ECC = 0.8775
V_BITWISE = 0.86
# Inside the undervolted domain (below the 0.98 V guardband, so the K3
# route runs with injection on) but above every fault onset: every rate
# column of the threshold table is 0, so no fault reaches the cache.
V_NO_FAULT = 0.975
# K3 against its plain version, element-wise over finite outputs (bf16).
K3_ATOL = K3_RTOL = 1e-2
# Kernels (and SDPA beside them) are timed queued behind a spin kernel of
# this many seconds (cuda_ms, which measures again behind a longer one if
# the host has not enqueued every rep before it ends): 84 wrapper calls
# enqueue in a few ms, and short kernels take less than their host work.
QUEUE_S = 0.05
MIN_FINITE_SHARE = 0.5
# The scheduler's shape: serving slots, slots per pool page (a page of one
# layer's K or V is 8 x 512 words, so it never straddles a 4096-word arena
# block), prompt tokens per prefill chunk, and a pool for about 5
# requests' pages so that retired pages are recycled.
SLOTS, PAGE_SLOTS, CHUNK = 4, 8, 64
SCHED_PAGES = 5 * (MAX_LEN // PAGE_SLOTS)
# Scheduler traffic: 8 prompt lengths, new tokens per request, and the
# prompt prefix requests 1 and 5 share.
SCHED_PROMPTS = (96, 288, 160, 384, 128, 320, 224, 352)
SCHED_NEW = (16, 48, 24, 40, 32, 20, 44, 28)
SHARED_PREFIX = 256
# Algorithm 1 at the paper's memSize: a whole VCU128 pseudo-channel (256
# MiB, 2**26 words) per test; the kernel checks use the paper's hot PC 19.
PC_WORDS = 1 << 26
SWEEP_PC = 19
# generate() under a rate governor on the 16-PC plan: admission takes the
# deepest voltage at which the cache's bytes fit on PCs whose stuck rate
# is <= the tolerable rate; at 1e-6 that is 0.89 V, between 0.91 and
# 0.88 V (the CPU tests hold the choice equal to the reference's).
GOV_TOLERABLE_RATE = 1e-6
# recurrentgemma-9b's generate() cell: batch 4, a prompt past the 2048-token
# local window, 32 new tokens; the scheduler cell: 3 slots, 6 requests
# (prompts 128..1024, 8..24 new tokens) in rings of the full window.
HYB_B, HYB_PROMPT, HYB_NEW, HYB_MAX_LEN = 4, 2560, 32, 4096
HYB_SLOTS, HYB_SCHED_MAX_LEN = 3, 2048
HYB_SCHED_PROMPTS = (128, 1024, 384, 640, 256, 896)
HYB_SCHED_NEW = (8, 24, 16, 12, 20, 10)


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1, queue_s: float = 0.0) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events).

    ``queue_s`` > 0 first parks the stream on a spin kernel of about that
    many seconds, so the timed launches queue up behind it while the host
    enqueues them: a kernel shorter than its wrapper's host work then runs
    back to back with the next, and the window measures device time, not
    the host's pace.  If the spin ended before the last launch was
    enqueued (the start event has completed by then), the queue did not
    cover the host time of the reps: the measure is repeated behind a
    spin four times as long."""
    import torch
    for _ in range(warmup):
        fn()
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_s > 0:
            torch.cuda.synchronize()
            torch.cuda._sleep(int(queue_s * 2e9))     # cycles at <= 2 GHz
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        drained = queue_s > 0 and start.query()
        torch.cuda.synchronize()
        if not drained:
            return start.elapsed_time(end) / reps
        if queue_s >= 2.0:
            raise AssertionError(f"cuda_ms: {reps} launches take the host "
                                 f"longer than a {queue_s} s queue")
        queue_s *= 4
        log(f"cuda_ms: the queue drained before {reps} launches were "
            f"enqueued; measuring again behind {queue_s:.2f} s")


def bound(bytes_moved: float, int_ops: float = 0.0, flops: float = 0.0,
          bf16_flops: float = 0.0, tf32_flops: float = 0.0):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = (int_ops / INT_OPS_PER_S + flops / F32_FLOPS_PER_S
             + bf16_flops / BF16_FLOPS_PER_S + tf32_flops / TF32_FLOPS_PER_S)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def plan_at(v: float, ecc: bool = False):
    """KV-cache domain on the 16 most reliable PCs at v (the reference's
    examples/resilient_inference.py plan)."""
    from repro_torch.core.domains import MemoryDomain
    from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
    from repro_torch.core.hbm import VCU128
    from repro_torch.training.undervolt import UndervoltPlan
    fmap = FaultMap.from_seed(VCU128, seed=PAPER_MAP_SEED)
    pcs = tuple(int(p) for p in fmap.usable_pcs(v, 1.0))[:16] or tuple(
        range(16))
    return UndervoltPlan(domains={"kv": MemoryDomain("kv", v, pcs, ecc=ecc)},
                         policy={"kv_cache": "kv"}, geometry=VCU128,
                         map_seed=PAPER_MAP_SEED)


def bits_equal(a, b) -> bool:
    import torch
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.shape == b.shape and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


def k3_compare(label: str, got, ref) -> float:
    """An attention kernel (K3, K4) against its plain version: the same
    NaN and infinity pattern, and |got - ref| <= K3_ATOL + K3_RTOL * |ref|
    on every finite entry.  Returns the largest absolute error over the
    finite entries."""
    import torch
    a, b = got.float(), ref.float()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise AssertionError(f"{label}: kernel and plain version differ "
                             "in NaN pattern")
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(a[~fin].nan_to_num(0.0), b[~fin].nan_to_num(0.0)):
        raise AssertionError(f"{label}: kernel and plain version differ "
                             "in infinities")
    diff = (a[fin] - b[fin]).abs()
    over = diff > K3_ATOL + K3_RTOL * b[fin].abs()
    if bool(over.any()):
        raise AssertionError(
            f"{label}: {int(over.sum())} finite outputs outside "
            f"{K3_ATOL} + {K3_RTOL}*|ref| (max abs err {float(diff.max())})")
    return float(diff.max()) if bool(fin.any()) else 0.0


def sass_per_word() -> dict:
    """SASS instructions per word of the shared mask math, counted with
    cuobjdump in csrc/sass_probe.cu (each probe minus its copy probe; ECC
    per codeword halved).  ``all`` counts every instruction; ``alu``
    leaves out loads, stores and control flow; ``probe_branches`` counts
    the probe's BRA (1 is the self-loop after EXIT: straight-line code).
    Empty where the toolkit has no cuobjdump."""
    import re
    from repro_torch.kernels import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not cuobjdump.exists():
        log("SASS per word: not measured (no cuobjdump beside nvcc)")
        return {}
    out_dir = ROOT / "build" / "sass_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / "sass_probe.cubin"
    subprocess.run([_build.nvcc_path(), "-cubin", "-arch=sm_90a",
                    "-std=c++17", "-O3", "-I", str(_build.CSRC), "-o",
                    str(cubin), str(_build.CSRC / "sass_probe.cu")],
                   check=True, capture_output=True, text=True, timeout=300)
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    counts, name = {}, None
    insn = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)")
    not_alu = ("LD", "ST", "BRA", "EXIT", "RET", "CALL", "BSYNC", "BSSY",
               "NOP", "BAR", "ULDC")
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"all": 0, "alu": 0, "branches": 0}
            continue
        m = insn.match(line)
        if name is None or m is None or m.group(1) == "NOP":
            continue
        op = m.group(1)
        counts[name]["all"] += 1
        counts[name]["branches"] += op == "BRA"
        if not op.startswith(not_alu):
            counts[name]["alu"] += 1
    per_word = {}
    for method, probe, base, words in (("word", "probe_word", "probe_copy", 1),
                                       ("bitwise", "probe_bitwise",
                                        "probe_copy", 1),
                                       ("ecc", "probe_ecc", "probe_copy2", 2)):
        per_word[method] = {k: (counts[probe][k] - counts[base][k]) / words
                            for k in ("all", "alu")}
        per_word[method]["probe_branches"] = counts[probe]["branches"]
    log(f"SASS per word (cuobjdump of csrc/sass_probe.cu, sm_90a): "
        f"{per_word}; source-level counts {OPS_PER_WORD}")
    return per_word


def kernel_phases(dev, ops_per_word):
    """Every kernel of the main path against its plain version, timed.
    ``ops_per_word``: integer operations per word behind the bounds."""
    import torch
    from repro_torch.core import engine
    from repro_torch.core.faultmap import COL_WEAK_ROW_Q
    from repro_torch.kernels.bitflip import bitflip, ops
    from repro_torch.kernels.ecc import ecc as ecc_mod
    from repro_torch.kernels.flash_attention import faulty
    from repro_torch.models.base import get_arch, spec_avals
    from repro_torch.serving import readpath

    bundle = get_arch("llama3.2-3b")
    cfg = bundle.cfg
    cache_avals = spec_avals(bundle.module.cache_specs(cfg, B, MAX_LEN))
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []

    # ---- K1 / K2: the whole-cache arena of the write-path init injection
    def arena_operands(v, ecc):
        plan = plan_at(v, ecc)
        placement = plan.place({"kv_cache": cache_avals})["kv_cache"]
        fmap = plan.fault_map()
        base, thr, _ = engine.device_tables(placement, fmap, v, dev)
        return fmap, base, thr

    fmap, base, _ = arena_operands(V_DENSE, False)
    nb = base.shape[0]
    words = nb * bitflip.BLOCK_WORDS
    arena = torch.randint(-2 ** 31, 2 ** 31 - 1, (words,), generator=gen,
                          dtype=torch.int32, device=dev)
    kw = dict(seed=fmap.seed, words_per_row_log2=fmap.words_per_row_log2)
    table_bytes = nb * 4 * (1 + 11)
    variants = {}
    for method, v in (("word", V_DENSE), ("bitwise", V_BITWISE)):
        _, base_m, thr_m = arena_operands(v, False)
        out = bitflip.arena_bitflip(arena, base_m, thr_m, method=method, **kw)
        ref = bitflip.arena_bitflip_ref(arena, base_m, thr_m, method=method,
                                        **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"K1 {method}: kernel != plain version")
        changed = int((out != arena).sum())
        if changed == 0:
            raise AssertionError(f"K1 {method}: injected no fault")
        def k1():
            return bitflip.arena_bitflip(arena, base_m, thr_m, method=method,
                                         **kw)
        ms = cuda_ms(k1, reps=10, queue_s=QUEUE_S)
        host_ms = cuda_ms(k1, reps=10)
        plain_ms = cuda_ms(lambda: bitflip.arena_bitflip_ref(
            arena, base_m, thr_m, method=method, **kw), reps=1, warmup=0)
        b_ms, b_by = bound(8 * words + table_bytes,
                           int_ops=words * ops_per_word[method])
        variants[method] = dict(max_abs_err=0.0, ms=ms, host_ms=host_ms,
                                plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, words_changed=changed,
                                voltage=v)
        log(f"K1 arena_bitflip[{method}] {nb} blocks @ {v} V: bit-equal to "
            f"plain, {changed} words changed; {ms:.4f} ms on the device, "
            f"{host_ms:.4f} ms at the eager host pace (bound {b_ms:.4f} ms "
            f"by {b_by}; plain {plain_ms:.2f} ms)")
    main = variants.pop("word")
    rows.append(dict(name="arena_bitflip", route="cuda",
                     source="src/repro_torch/kernels/csrc/arena_bitflip.cu",
                     replaces="src/repro/kernels/bitflip/bitflip.py:186",
                     library_ms=None, **main, variants=variants))

    _, base_e, thr_e = arena_operands(V_DENSE_ECC, True)
    out, bad, corr = ecc_mod.arena_ecc(arena, base_e, thr_e, **kw)
    ref = ecc_mod.arena_ecc_ref(arena, base_e, thr_e, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(out, ref[0]) and torch.equal(bad, ref[1])
            and torch.equal(corr, ref[2])):
        raise AssertionError("K2: kernel != plain version (data or counts)")
    n_corr, n_bad = int(corr.sum()), int(bad.sum())
    changed = int((out != arena).sum())
    if n_corr == 0 or n_bad == 0:
        raise AssertionError(f"K2 @ {V_DENSE_ECC} V: {n_corr} corrected and "
                             f"{n_bad} uncorrectable codewords; the check "
                             "needs both")
    ms = cuda_ms(lambda: ecc_mod.arena_ecc(arena, base_e, thr_e, **kw),
                 reps=10, queue_s=QUEUE_S)
    host_ms = cuda_ms(lambda: ecc_mod.arena_ecc(arena, base_e, thr_e, **kw),
                      reps=10)
    plain_ms = cuda_ms(lambda: ecc_mod.arena_ecc_ref(arena, base_e, thr_e,
                                                     **kw), reps=1, warmup=0)
    b_ms, b_by = bound(8 * words + table_bytes + 8 * nb,
                       int_ops=words * ops_per_word["ecc"])
    rows.append(dict(name="arena_ecc", route="cuda",
                     source="src/repro_torch/kernels/csrc/arena_ecc.cu",
                     replaces="src/repro/kernels/ecc/ecc.py:105",
                     max_abs_err=0.0, ms=ms, host_ms=host_ms,
                     plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, variants={}, corrected=n_corr,
                     uncorrectable=n_bad, words_changed=changed,
                     voltage=V_DENSE_ECC))
    log(f"K2 arena_ecc {nb} blocks @ {V_DENSE_ECC} V: bits and counts equal "
        f"({n_corr} corrected, {n_bad} uncorrectable, {changed} words "
        f"changed); {ms:.4f} ms on the device, {host_ms:.4f} ms at the "
        f"eager host pace (bound {b_ms:.4f} ms by {b_by}; plain "
        f"{plain_ms:.2f} ms)")
    del arena, out, ref

    # ---- K3: one decode step's attention over each layer of the cache
    H, KH, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, MAX_LEN
    n_layers = cfg.n_layers
    stack = lambda: torch.randn((n_layers, B, L, KH, D), generator=gen,  # noqa: E731
                                device=dev).to(torch.bfloat16)
    k_leaf, v_leaf = stack(), stack()
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(L, dtype=torch.int32, device=dev).expand(B, L).contiguous()
    q_pos = L + 5
    clean = q_pos % L

    def ctx_for(v, ecc, method, inject):
        plan = plan_at(v, ecc)
        pl = plan.place({"kv_cache": cache_avals})["kv_cache"]
        return readpath.build_ctx(pl, plan.fault_map(), cache_avals,
                                  voltage=v, method=method, inject=inject,
                                  device=dev)

    def attend(c, layer, k, v_, which=faulty.faulty_decode_attention):
        e = c.entries["s0_global"]
        return which(q, k, v_, pos, q_pos=q_pos, k_tables=(e.k.base, e.k.thr),
                     v_tables=(e.v.base, e.v.thr),
                     k_word0=layer * e.k.layer_words,
                     v_word0=layer * e.v.layer_words, seed=c.seed,
                     method=c.method, words_per_row_log2=c.words_per_row_log2,
                     ecc=c.ecc, inject=c.inject, clean_slot=clean)

    layer = n_layers - 1
    n_out = B * H * D
    uninjected = attend(ctx_for(V_DENSE, False, "word", False), layer,
                        k_leaf[layer], v_leaf[layer])
    # The serving phases' no-fault reference: at V_NO_FAULT the K3 route
    # injects through an all-zero rate table and must give the uninjected
    # output bit for bit.
    thr0 = plan_at(V_NO_FAULT).fault_map().threshold_table(V_NO_FAULT)
    rate_cols = [i for i in range(thr0.shape[1]) if i != COL_WEAK_ROW_Q]
    if bool(thr0[:, rate_cols].any()):
        raise AssertionError(f"{V_NO_FAULT} V: a fault rate is not zero")
    nofault = attend(ctx_for(V_NO_FAULT, False, "word", True), layer,
                     k_leaf[layer], v_leaf[layer])
    if not bits_equal(nofault, uninjected):
        raise AssertionError(f"K3 at {V_NO_FAULT} V (zero rates) != K3 "
                             "without injection")
    log(f"K3 with injection at {V_NO_FAULT} V (all fault rates 0) == K3 "
        "without injection: bit-equal")

    # The split ring: its shape, and each row's bits at B = 1 equal to its
    # row at B = B (the split reads only the ring length and the tile).
    bkv = faulty.pick_bkv(L, KH * D // 2)
    tps, n_splits = faulty.decode_splits(L, bkv)
    k3_split = dict(bkv=bkv, tiles_per_split=tps, splits=n_splits,
                    blocks=KH * B * n_splits)
    log(f"K3 split ring: tile {bkv} slots, {tps} tile(s) per split, "
        f"{n_splits} splits, grid {KH} x {B} x {n_splits} = "
        f"{k3_split['blocks']} blocks")
    wps = KH * D // 2
    for inject in (True, False):
        c = ctx_for(V_DENSE, False, "word", inject)
        e = c.entries["s0_global"]
        full = attend(c, layer, k_leaf[layer], v_leaf[layer])
        for b in range(B):
            word0 = layer * e.k.layer_words + b * L * wps
            one = faulty.faulty_decode_attention(
                q[b:b + 1], k_leaf[layer][b:b + 1], v_leaf[layer][b:b + 1],
                pos[b:b + 1], q_pos=q_pos, k_tables=(e.k.base, e.k.thr),
                v_tables=(e.v.base, e.v.thr), k_word0=word0,
                v_word0=layer * e.v.layer_words + b * L * wps, seed=c.seed,
                method=c.method, words_per_row_log2=c.words_per_row_log2,
                ecc=c.ecc, inject=c.inject, clean_slot=clean)
            if not bits_equal(one, full[b:b + 1]):
                raise AssertionError(f"K3 inject={inject}: row {b} alone != "
                                     f"row {b} of the B = {B} launch")
    log(f"K3 at B = {B} == K3 one row at a time, bits, injection on and off")

    kv_bytes = 2 * B * L * KH * D * 2
    kv_words = kv_bytes // 4
    attn_flops = 4 * B * H * L * D
    io_bytes = kv_bytes + B * L * 4 + 2 * B * H * D * 2
    k3 = {}
    for label, v, ecc, method, inject in (
            ("read_word", V_DENSE, False, "word", True),
            ("inject_off", V_DENSE, False, "word", False),
            ("read_ecc", V_DENSE_ECC, True, "word", True),
            ("read_bitwise", V_DENSE, False, "bitwise", True)):
        c = ctx_for(v, ecc, method, inject)
        got = attend(c, layer, k_leaf[layer], v_leaf[layer])
        ref = attend(c, layer, k_leaf[layer], v_leaf[layer],
                     which=faulty.faulty_decode_attention_ref)
        torch.cuda.synchronize()
        err = k3_compare(f"K3 {label}", got, ref)
        extra = {}
        if inject:
            finite = float(torch.isfinite(got.float()).float().mean())
            n_diff = int((got.view(torch.int16)
                          != uninjected.view(torch.int16)).sum())
            if finite < MIN_FINITE_SHARE:
                raise AssertionError(f"K3 {label}: only {finite:.3f} of the "
                                     "outputs are finite")
            if n_diff < 0.01 * n_out:
                raise AssertionError(f"K3 {label}: only {n_diff} of {n_out} "
                                     "outputs differ from the uninjected "
                                     "output")
            # read path == write path on bits: inject on a clean cache vs
            # no injection on the cache corrupted by the plain path, the
            # current slot's value still clean (store buffer).
            e = c.entries["s0_global"]
            corrupted, changed = [], 0
            for leaf, half in ((k_leaf, e.k), (v_leaf, e.v)):
                u32, meta = ops.to_u32(leaf[layer])
                offs = layer * half.layer_words + torch.arange(
                    u32.shape[0], dtype=torch.int64, device=dev)
                out_w, _ = engine.corrupt_words(
                    u32, offs, half.base, half.thr, seed=c.seed,
                    method=method, words_per_row_log2=c.words_per_row_log2,
                    ecc=ecc)
                changed += int((out_w != u32).sum())
                x = ops.from_u32(out_w, meta)
                x[:, clean] = leaf[layer][:, clean]   # still in the store buffer
                corrupted.append(x)
            write = attend(ctx_for(v, ecc, method, False), layer, *corrupted)
            if not bits_equal(got, write):
                raise AssertionError(f"K3 {label}: read-path output != "
                                     "attention over the write-path-"
                                     "corrupted cache")
            extra = dict(finite_share=finite, outputs_changed=n_diff,
                         words_changed_in_layer=changed)
            log(f"K3 {label} @ {v} V: {changed} K/V words of the layer "
                f"changed, {n_diff} of {n_out} outputs changed by injection, "
                f"finite share {finite:.4f}; read path == attention over "
                "the write-path-corrupted cache: bit-equal")
        def every_layer():
            return [attend(c, i, k_leaf[i], v_leaf[i])
                    for i in range(n_layers)]
        ms = cuda_ms(every_layer, reps=3, queue_s=QUEUE_S) / n_layers
        host_ms = cuda_ms(every_layer, reps=3) / n_layers
        plain_ms = cuda_ms(lambda: attend(
            c, layer, k_leaf[layer], v_leaf[layer],
            which=faulty.faulty_decode_attention_ref), reps=1, warmup=0)
        n_ops = (kv_words * (ops_per_word["ecc" if ecc else method]
                             + K3_ADDR_OPS) if inject else 0)
        b_ms, b_by = bound(io_bytes, int_ops=n_ops, flops=attn_flops)
        k3[label] = dict(max_abs_err=err, ms=ms, host_ms=host_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         voltage=v, **extra)
        log(f"K3 faulty_decode_attention[{label}] (B={B}, L={L}, KH={KH}, "
            f"G={H // KH}, D={D}) @ {v} V: max abs err {err:.3g} vs plain "
            f"(finite outputs); {ms * 1e3:.2f} us/layer on the device, "
            f"{host_ms * 1e3:.2f} us/layer at the eager host pace (bound "
            f"{b_ms * 1e3:.2f} us by {b_by}; plain {plain_ms:.2f} ms)")

    # SDPA yardstick for K3 without injection (the port never calls it)
    import torch.nn.functional as F
    qt = q.transpose(1, 2).contiguous()
    kt = k_leaf.permute(0, 1, 3, 2, 4).contiguous()
    vt = v_leaf.permute(0, 1, 3, 2, 4).contiguous()
    sdpa_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(
        qt, kt[i], vt[i], enable_gqa=True) for i in range(n_layers)],
        reps=3, queue_s=QUEUE_S) / n_layers
    k3["inject_off"]["library_ms"] = sdpa_ms
    log(f"SDPA yardstick (no injection, enable_gqa): {sdpa_ms * 1e3:.2f} "
        "us/layer on the device")
    main = k3.pop("read_word")
    rows.append(dict(name="faulty_decode_attention", route="cuda",
                     source="src/repro_torch/kernels/csrc/faulty_decode.cu",
                     replaces="src/repro/kernels/flash_attention/faulty.py:238",
                     library_ms=None, **main, variants=k3, **k3_split))
    del k_leaf, v_leaf, kt, vt
    torch.cuda.empty_cache()
    return rows


def paged_kernel_phase(dev, ops_per_word):
    """K4 at the scheduler's shape: a period-stacked llama3.2-3b pool of
    SLOTS x 128 shuffled pages of PAGE_SLOTS slots (plus scratch), some
    slots partly empty (pos -1), in the 16-PC domain; against its plain
    version, against K3 over the same words in ring order, and timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import hashing as H
    from repro_torch.kernels.flash_attention import faulty
    from repro_torch.models.base import get_arch
    from repro_torch.serving.paged import PagePool

    bundle = get_arch("llama3.2-3b")
    cfg = bundle.cfg
    H_, KH, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, MAX_LEN
    n_layers, S, PS = cfg.n_layers, SLOTS, PAGE_SLOTS
    n_lp = L // PS
    num_pages = S * n_lp
    total = num_pages + 1
    gen = torch.Generator(device=dev).manual_seed(4)
    pool_k = torch.randn((n_layers, total, PS, KH, D), generator=gen,
                         device=dev).to(torch.bfloat16)
    pool_v = torch.randn((n_layers, total, PS, KH, D), generator=gen,
                         device=dev).to(torch.bfloat16)
    q = torch.randn((S, 1, H_, D), generator=gen, device=dev).to(
        torch.bfloat16)
    perm = torch.randperm(num_pages, generator=torch.Generator().manual_seed(5))
    ptab = perm.reshape(S, n_lp).to(torch.int32).to(dev)
    # each slot holds positions 0..fill-1 in ring order and decodes at
    # q_pos (slot 0 has wrapped: its clean slot is 5)
    fill = [L, L - L // 25, 2 * L // 3, L // 3]
    q_pos = torch.tensor([L + 5] + fill[1:], dtype=torch.int32, device=dev)
    pos_pool = torch.full((total, PS), -1, dtype=torch.int32, device=dev)
    ring = torch.arange(L, dtype=torch.int32, device=dev)
    for s_, f in enumerate(fill):
        pos_pool[ptab[s_].long()] = torch.where(ring < f, ring, -1).reshape(
            n_lp, PS)
    layer = n_layers - 1
    n_out = S * H_ * D
    tps, n_splits = faulty.decode_splits(L, PS)
    k4_split = dict(tiles_per_split=tps, splits=n_splits,
                    blocks=KH * S * n_splits)
    log(f"K4 split ring: pages of {PS} slots, {tps} page(s) per split, "
        f"{n_splits} splits, grid {KH} x {S} x {n_splits} = "
        f"{k4_split['blocks']} blocks")

    def tables(v, ecc):
        pool = PagePool(bundle.module, cfg, max_len=L, page_slots=PS,
                        num_pages=num_pages, plan=plan_at(v, ecc))
        thr = pool.faultmap.threshold_table(v)
        out = {}
        for leaf in pool.leaves:
            if leaf.which in ("k", "v"):
                out[leaf.which] = [
                    (H.as_i32(torch.from_numpy(
                        leaf.page_base[i].astype("int64"))).to(dev),
                     thr[torch.from_numpy(leaf.page_pc[i].astype(
                         "int64"))].to(dev).contiguous())
                    for i in range(n_layers)]
        return pool.faultmap, out

    def k4(fmap, tabs, i, method, ecc, inject, telemetry=False,
           which=faulty.paged_decode_attention):
        return which(q, pool_k[i], pool_v[i], pos_pool, ptab, q_pos=q_pos,
                     k_tables=tabs["k"][i], v_tables=tabs["v"][i],
                     seed=fmap.seed, method=method,
                     words_per_row_log2=fmap.words_per_row_log2, ecc=ecc,
                     inject=inject, telemetry=telemetry)

    def k3_rows(fmap, tabs, i, method, ecc, inject):
        """K3 over the same words gathered into each slot's ring, with
        page-granular tables and a tile of one page, one slot at a time."""
        outs = []
        for s_ in range(S):
            pids = ptab[s_].long()
            rk = pool_k[i][pids].reshape(1, L, KH, D).contiguous()
            rv = pool_v[i][pids].reshape(1, L, KH, D).contiguous()
            rp = pos_pool[pids].reshape(1, L).contiguous()
            kt = tuple(t[pids].contiguous() for t in tabs["k"][i])
            vt = tuple(t[pids].contiguous() for t in tabs["v"][i])
            outs.append(faulty.faulty_decode_attention(
                q[s_:s_ + 1], rk, rv, rp, q_pos=int(q_pos[s_]),
                k_tables=kt, v_tables=vt, k_word0=0, v_word0=0,
                seed=fmap.seed, method=method,
                words_per_row_log2=fmap.words_per_row_log2, ecc=ecc,
                inject=inject, clean_slot=int(q_pos[s_]) % L, bkv=PS,
                words_log2=(PS * KH * D // 2).bit_length() - 1))
        return torch.cat(outs)

    kv_bytes = 2 * S * L * KH * D * 2
    kv_words = kv_bytes // 4
    attn_flops = 4 * S * H_ * L * D
    io_bytes = kv_bytes + S * L * 4 + 2 * S * H_ * D * 2 + S * n_lp * 4
    variants = {}
    for label, v, ecc, method in (("read_word", V_DENSE, False, "word"),
                                  ("read_bitwise", V_DENSE, False, "bitwise"),
                                  ("read_ecc", V_DENSE_ECC, True, "word")):
        fmap, tabs = tables(v, ecc)
        got = k4(fmap, tabs, layer, method, ecc, True)
        ref = k4(fmap, tabs, layer, method, ecc, True,
                 which=faulty.paged_decode_attention_ref)
        off = k4(fmap, tabs, layer, method, ecc, False)
        torch.cuda.synchronize()
        err = k3_compare(f"K4 {label}", got, ref)
        finite = float(torch.isfinite(got.float()).float().mean())
        n_diff = int((got.view(torch.int16) != off.view(torch.int16)).sum())
        if n_diff < 0.01 * n_out:
            raise AssertionError(f"K4 {label}: only {n_diff} of {n_out} "
                                 "outputs differ from the uninjected output")
        for inject, out in ((True, got), (False, off)):
            if not bits_equal(out, k3_rows(fmap, tabs, layer, method, ecc,
                                           inject)):
                raise AssertionError(f"K4 {label} inject={inject}: != K3 "
                                     "over the same words (page tiles)")
        extra = {}
        if ecc:
            (_, cnt), (_, ref_cnt) = (
                k4(fmap, tabs, layer, method, ecc, True, telemetry=True),
                k4(fmap, tabs, layer, method, ecc, True, telemetry=True,
                   which=faulty.paged_decode_attention_ref))
            if not torch.equal(cnt, ref_cnt) or int(cnt.sum()) == 0:
                raise AssertionError(
                    f"K4 telemetry: kernel {int(cnt.sum())} vs plain "
                    f"{int(ref_cnt.sum())} corrected codewords")
            extra["corrected_codewords"] = int(cnt.sum())
        def every_layer():
            return [k4(fmap, tabs, i, method, ecc, True)
                    for i in range(n_layers)]
        ms = cuda_ms(every_layer, reps=3, queue_s=QUEUE_S) / n_layers
        host_ms = cuda_ms(every_layer, reps=3) / n_layers
        plain_ms = cuda_ms(lambda: k4(
            fmap, tabs, layer, method, ecc, True,
            which=faulty.paged_decode_attention_ref), reps=1, warmup=0)
        b_ms, b_by = bound(io_bytes, int_ops=kv_words * (
            ops_per_word["ecc" if ecc else method] + K3_ADDR_OPS),
            flops=attn_flops)
        variants[label] = dict(max_abs_err=err, ms=ms, host_ms=host_ms,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, voltage=v,
                               finite_share=finite, outputs_changed=n_diff,
                               **extra)
        log(f"K4 paged_decode_attention[{label}] (S={S}, {n_lp} pages of "
            f"{PS}, KH={KH}, G={H_ // KH}, D={D}) @ {v} V: max abs err "
            f"{err:.3g} vs plain (finite outputs), {n_diff} of {n_out} "
            f"outputs changed by injection, finite share {finite:.4f}; "
            f"== K3 over the same words, bits, injection on and off"
            + (f"; telemetry {extra['corrected_codewords']} corrected "
               "codewords == plain" if ecc else "")
            + f"; {ms * 1e3:.2f} us/layer on the device, "
            f"{host_ms * 1e3:.2f} us/layer at the eager host pace (bound "
            f"{b_ms * 1e3:.2f} us by {b_by}; plain {plain_ms:.2f} ms)")
    fmap, tabs = tables(V_DENSE, False)

    def every_layer(inject=False):
        return [k4(fmap, tabs, i, "word", False, inject)
                for i in range(n_layers)]
    ms_off = cuda_ms(every_layer, reps=3, queue_s=QUEUE_S) / n_layers
    host_off = cuda_ms(every_layer, reps=3) / n_layers
    b_off, by_off = bound(io_bytes, flops=attn_flops)
    # The measurement behind faulty.SPLIT_SLOTS: K4 at half the split
    # (twice the blocks, in two waves), checked against the plain version.
    ref = k4(fmap, tabs, layer, "word", False, True,
             which=faulty.paged_decode_attention_ref)
    split_slots = faulty.SPLIT_SLOTS
    faulty.SPLIT_SLOTS = split_slots // 2
    try:
        n_half = faulty.decode_splits(L, PS)[1]
        err = k3_compare("K4 read_word at half splits",
                         k4(fmap, tabs, layer, "word", False, True), ref)
        half = {"inject_off": cuda_ms(every_layer, reps=3, queue_s=QUEUE_S),
                "read_word": cuda_ms(lambda: every_layer(True), reps=3,
                                     queue_s=QUEUE_S)}
    finally:
        faulty.SPLIT_SLOTS = split_slots
    for label, t in half.items():
        variants[f"{label}_split{split_slots // 2}"] = dict(
            ms=t / n_layers, splits=n_half, blocks=KH * S * n_half,
            max_abs_err=err if label == "read_word" else None)
    log(f"K4 at {split_slots // 2}-slot splits ({KH * S * n_half} blocks): "
        f"read/word {half['read_word'] / n_layers * 1e3:.2f} us/layer, "
        f"without injection {half['inject_off'] / n_layers * 1e3:.2f} "
        f"us/layer on the device (max abs err {err:.3g} vs plain)")
    # SDPA yardstick on the gathered contiguous K/V (the port never calls it)
    idx = ptab.reshape(-1).long()
    gk = [pool_k[i][idx].reshape(S, L, KH, D).transpose(1, 2).contiguous()
          for i in range(n_layers)]
    gv = [pool_v[i][idx].reshape(S, L, KH, D).transpose(1, 2).contiguous()
          for i in range(n_layers)]
    qt = q.transpose(1, 2).contiguous()
    sdpa_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(
        qt, gk[i], gv[i], enable_gqa=True) for i in range(n_layers)],
        reps=3, queue_s=QUEUE_S) / n_layers
    variants["inject_off"] = dict(ms=ms_off, host_ms=host_off, bound_ms=b_off,
                                  bound_by=by_off, library_ms=sdpa_ms)
    log(f"K4 without injection {ms_off * 1e3:.2f} us/layer on the device, "
        f"{host_off * 1e3:.2f} us/layer at the eager host pace (bound "
        f"{b_off * 1e3:.2f} us by {by_off}); SDPA on the gathered K/V "
        f"{sdpa_ms * 1e3:.2f} us/layer on the device")
    main = variants.pop("read_word")
    del pool_k, pool_v, gk, gv
    torch.cuda.empty_cache()
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_decode.cu",
                replaces="src/repro/kernels/flash_attention/faulty.py:433",
                library_ms=sdpa_ms, **main, variants=variants, **k4_split)


def segment_kernel_phase(dev, ops_per_word):
    """K5 and K6 at the Algorithm 1 shape (one whole VCU128 PC, 2**26
    words) against their plain versions, K5 against K1 over the same PC
    laid out as arena blocks, a run wrapping past word 2**32 and an
    unaligned ECC run whose zero-padded tail counts; timed."""
    import torch
    from repro_torch.core import hashing as H
    from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
    from repro_torch.core.hbm import VCU128
    from repro_torch.kernels.bitflip import bitflip
    from repro_torch.kernels.ecc import ecc as ecc_mod
    from repro_torch.kernels.ecc import ops as ecc_ops

    fmap = FaultMap.from_seed(VCU128, seed=PAPER_MAP_SEED)
    n = PC_WORDS
    base = SWEEP_PC * PC_WORDS
    gen = torch.Generator(device=dev).manual_seed(8)
    data = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                         dtype=torch.int32, device=dev)
    nb = n // bitflip.BLOCK_WORDS
    k1_base = H.as_i32(base + bitflip.BLOCK_WORDS * torch.arange(
        nb, dtype=torch.int64, device=dev))
    variants = {}
    for method, v in (("word", V_DENSE), ("bitwise", V_BITWISE)):
        thr = fmap.thresholds(v, SWEEP_PC)
        kw = dict(thresholds=thr, seed=fmap.seed, base_word=base,
                  method=method)
        out = bitflip.bitflip(data, **kw)
        ref = bitflip.bitflip_ref(data, **kw)
        row = H.as_i32(torch.tensor(bitflip.threshold_row(thr)))
        k1 = bitflip.arena_bitflip(
            data, k1_base, row.to(dev).expand(nb, -1).contiguous(),
            seed=fmap.seed, method=method,
            words_per_row_log2=thr.words_per_row_log2)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError(f"K5 {method}: kernel != plain version")
        if not torch.equal(out, k1):
            raise AssertionError(f"K5 {method}: != K1 over the same PC")
        changed = int((out != data).sum())
        if changed == 0:
            raise AssertionError(f"K5 {method}: injected no fault")
        ms = cuda_ms(lambda: bitflip.bitflip(data, **kw), reps=10,
                     queue_s=QUEUE_S)
        host_ms = cuda_ms(lambda: bitflip.bitflip(data, **kw), reps=10)
        plain_ms = cuda_ms(lambda: bitflip.bitflip_ref(data, **kw), reps=1,
                           warmup=0)
        b_ms, b_by = bound(8 * n, int_ops=n * ops_per_word[method])
        variants[method] = dict(max_abs_err=0.0, ms=ms, host_ms=host_ms,
                                plain_ms=plain_ms, bound_ms=b_ms,
                                bound_by=b_by, words_changed=changed,
                                voltage=v)
        log(f"K5 bitflip[{method}] one PC ({n} words, PC {SWEEP_PC}) @ {v} "
            f"V: bit-equal to plain and to K1 over the same blocks, "
            f"{changed} words changed; {ms:.4f} ms on the device, "
            f"{host_ms:.4f} ms at the eager host pace (bound {b_ms:.4f} ms "
            f"by {b_by}; plain {plain_ms:.2f} ms)")
    # physical word ids are uint32: a ragged run wrapping past 2**32
    wrap_base, wrap_n = 2 ** 32 - 2 * bitflip.BLOCK_WORDS - 3, 4 * 4096 + 5
    for method, v in (("word", V_DENSE), ("bitwise", V_BITWISE)):
        kw = dict(thresholds=fmap.thresholds(v, SWEEP_PC), seed=fmap.seed,
                  base_word=wrap_base, method=method)
        out = bitflip.bitflip(data[:wrap_n], **kw)
        if not torch.equal(out, bitflip.bitflip_ref(data[:wrap_n], **kw)):
            raise AssertionError(f"K5 {method} wrapping past 2**32: kernel "
                                 "!= plain version")
    log(f"K5 word and bitwise over {wrap_n} words from word {wrap_base} "
        "(wrapping past 2**32): bit-equal to plain")
    main = variants.pop("word")
    rows = [dict(name="bitflip", route="cuda",
                 source="src/repro_torch/kernels/csrc/segment_bitflip.cu",
                 replaces="src/repro/kernels/bitflip/bitflip.py:63",
                 library_ms=None, **main, variants=variants)]

    ecc_rows = {}
    for v in (V_DENSE_ECC, V_FAULTY):
        kw = dict(thresholds=fmap.thresholds(v, SWEEP_PC), seed=fmap.seed,
                  base_word=base)
        out, bad = ecc_mod.segment_ecc(data, **kw)
        ref, ref_bad = ecc_mod.segment_ecc_ref(data, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(bad, ref_bad)):
            raise AssertionError(f"K6 @ {v} V: kernel != plain version")
        n_bad, changed = int(bad.sum()), int((out != data).sum())
        ms = cuda_ms(lambda: ecc_mod.segment_ecc(data, **kw), reps=10,
                     queue_s=QUEUE_S)
        host_ms = cuda_ms(lambda: ecc_mod.segment_ecc(data, **kw), reps=10)
        plain_ms = cuda_ms(lambda: ecc_mod.segment_ecc_ref(data, **kw),
                           reps=1, warmup=0)
        b_ms, b_by = bound(8 * n + 4 * nb, int_ops=n * ops_per_word["ecc"])
        ecc_rows[v] = dict(max_abs_err=0.0, ms=ms, host_ms=host_ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           uncorrectable=n_bad, words_changed=changed,
                           voltage=v)
        log(f"K6 segment_ecc one PC @ {v} V: bits and counts equal to plain "
            f"({n_bad} uncorrectable codewords, {changed} words changed); "
            f"{ms:.4f} ms on the device, {host_ms:.4f} ms at the eager host "
            f"pace (bound {b_ms:.4f} ms by {b_by}; plain {plain_ms:.2f} ms)")
    if ecc_rows[V_DENSE_ECC]["uncorrectable"] == 0:
        raise AssertionError(f"K6 @ {V_DENSE_ECC} V: no uncorrectable "
                             "codeword")
    # an unaligned run: the default route counts the zero-padded tail of
    # its last block (the reference's kernel route), use_ref does not
    tail_n = 4 * 4096 + 100
    kw = dict(thresholds=fmap.thresholds(V_BITWISE, SWEEP_PC),
              seed=fmap.seed, base_word=base)
    out, bad = ecc_mod.segment_ecc(data[:tail_n], **kw)
    ref, ref_bad = ecc_mod.segment_ecc_ref(data[:tail_n], **kw)
    _, run_only = ecc_ops.inject_and_correct_u32(data[:tail_n], use_ref=True,
                                                 **kw)
    if not (torch.equal(out, ref) and torch.equal(bad, ref_bad)):
        raise AssertionError("K6 unaligned run: kernel != plain version")
    tail = int(bad.sum()) - int(run_only)
    if tail <= 0:
        raise AssertionError(f"K6 unaligned run: the padded tail holds {tail} "
                             "uncorrectable codewords; the check needs some")
    log(f"K6 over {tail_n} words @ {V_BITWISE} V: bits and counts equal to "
        f"plain; {int(bad.sum())} uncorrectable codewords, {tail} of them in "
        "the zero-padded tail of the last block (the oracle route counts "
        f"{int(run_only)})")
    main = ecc_rows.pop(V_DENSE_ECC)
    rows.append(dict(name="segment_ecc", route="cuda",
                     source="src/repro_torch/kernels/csrc/segment_ecc.cu",
                     replaces="src/repro/kernels/ecc/ecc.py:40",
                     library_ms=None, **main,
                     variants={f"{V_FAULTY}V": ecc_rows[V_FAULTY],
                               "unaligned_tail": dict(
                                   words=tail_n, uncorrectable=int(bad.sum()),
                                   padded_tail_uncorrectable=tail)}))
    del data, out, ref, k1
    torch.cuda.empty_cache()
    return rows


def sweep_phase(dev):
    """The paper's Algorithm 1 at full width: every VCU128 PC, both
    patterns, the 40-point 10 mV grid, a whole PC (2**26 words) per test,
    held to the plain version's counts and to the reference's own
    Algorithm 1 assertions."""
    import numpy as np
    import torch
    from repro_torch.core import reliability as rel
    from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
    from repro_torch.core.hbm import VCU128
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitflip.ops import pick_method

    fmap = FaultMap.from_seed(VCU128, seed=PAPER_MAP_SEED)
    grid = rel.voltage_grid()
    pcs = list(range(VCU128.num_pcs))
    patterns = (rel.ALL_ZEROS, rel.ALL_ONES)
    timings = {}
    _build.reset_launch_counts()          # the sweep's path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rel.sweep(fmap, pcs=pcs, mem_words=PC_WORDS, patterns=patterns,
                    method="auto", device=dev, timings=timings)
    wall = time.perf_counter() - t0
    k5 = _build.launch_counts()["segment_bitflip"]   # ... and ends here
    n_tests = len(grid) * len(pcs) * len(patterns)
    if k5 != n_tests or sum(len(r) for r in res.values()) != n_tests:
        raise AssertionError(f"sweep: {k5} K5 launches for {n_tests} tests")

    def result(v, pc, pattern):
        return [t for t in res[float(v)]
                if t.pc == pc and t.pattern == pattern][0]

    def count(v, pc, pattern):
        return result(v, pc, pattern).fault_counts[0]

    # the plain version's counts at the kernel phase's points
    for v in (V_DENSE, V_BITWISE):
        for p in patterns:
            plain = rel.run_pc_test(fmap, v, SWEEP_PC, mem_words=PC_WORDS,
                                    pattern=p, method="auto", use_ref=True,
                                    device=dev).fault_counts[0]
            if plain != count(v, SWEEP_PC, p):
                raise AssertionError(f"sweep @ {v} V PC {SWEEP_PC} pattern "
                                     f"{p:#x}: {count(v, SWEEP_PC, p)} flips "
                                     f"!= plain {plain}")
    # the guardband: no flip anywhere at or above V_min
    for v in grid[grid >= 0.98 - 1e-9]:
        if any(t.fault_counts != (0,) for t in res[float(v)]):
            raise AssertionError(f"sweep: flips at {v} V (guardband)")
    # the reference's own Algorithm 1 assertions, at the full PC
    grow = [count(v, 19, rel.ALL_ZEROS) for v in (0.92, 0.90, 0.88)]
    if not (0 < grow[0] < grow[1] < grow[2]):
        raise AssertionError(f"sweep PC 19: counts {grow} do not grow over "
                             "0.92 / 0.90 / 0.88 V")
    z, o = count(0.88, 19, rel.ALL_ZEROS), count(0.88, 19, rel.ALL_ONES)
    if not z > o:
        raise AssertionError(f"sweep PC 19 @ 0.88 V: zeros {z} !> ones {o}")
    observed = rel.observed_rate(result(0.88, 18, rel.ALL_ZEROS))
    expected = float(fmap.pc_rates(0.88)[0][18])
    if abs(observed - expected) > 0.2 * expected:
        raise AssertionError(f"sweep PC 18 @ 0.88 V: observed rate "
                             f"{observed:.3e} vs model {expected:.3e}")
    if pick_method(fmap.thresholds(0.83, 0)) != "bitwise":
        raise AssertionError("0.83 V PC 0 should take the bitwise path")
    deep = rel.observed_rate(result(0.83, 0, rel.ALL_ZEROS))
    if not deep > 0.4:
        raise AssertionError(f"sweep PC 0 @ 0.83 V: observed rate {deep}")
    transient = rel.run_pc_test(fmap, 0.89, 4, mem_words=PC_WORDS,
                                batch_size=3, transient_rate=1e-5, seed=7,
                                method="auto", device=dev)
    if len(set(transient.fault_counts)) < 2:
        raise AssertionError(f"transient batches {transient.fault_counts} "
                             "all equal")
    summary = {}
    for v in grid:
        tests = res[float(v)]
        summary[f"{v:.2f}"] = dict(
            flips=int(sum(t.fault_counts[0] for t in tests)),
            zero_flip_pcs=int(sum(all(t.fault_counts == (0,) for t in tests
                                      if t.pc == pc) for pc in pcs)))
    log("sweep per voltage (total flips over 32 PCs x 2 patterns, PCs with "
        "no flip): " + ", ".join(
            f"{v} V {s['flips']} / {s['zero_flip_pcs']}"
            for v, s in summary.items()))
    n_word = int(timings.get("tests_word", 0))
    n_bit = int(timings.get("tests_bitwise", 0))
    row = dict(wall_s=wall, tests=n_tests, k5_launches=k5,
               tests_word=n_word, tests_bitwise=n_bit,
               inject_word_s=timings.get("inject_word_s", 0.0),
               inject_bitwise_s=timings.get("inject_bitwise_s", 0.0),
               count_s=timings["count_s"],
               inject_word_ms_per_test=(1e3 * timings["inject_word_s"] / n_word
                                        if n_word else None),
               inject_bitwise_ms_per_test=(
                   1e3 * timings["inject_bitwise_s"] / n_bit if n_bit
                   else None),
               count_ms_per_test=1e3 * timings["count_s"] / n_tests,
               bytes_k5=8 * PC_WORDS * n_tests,
               pc18_observed_vs_model=[observed, expected],
               pc0_083_observed=deep, pc19_counts_092_090_088=grow,
               transient_counts=list(transient.fault_counts),
               per_voltage=summary)
    log(f"sweep: {n_tests} tests ({len(grid)} voltages x {len(pcs)} PCs x 2 "
        f"patterns x {PC_WORDS} words, {n_word} word-path, {n_bit} bitwise), "
        f"{k5} K5 launches, {wall:.2f} s wall: K5 word "
        f"{row['inject_word_s']:.2f} s, K5 bitwise "
        f"{row['inject_bitwise_s']:.2f} s, counting {row['count_s']:.2f} s "
        f"(per test {row['inject_word_ms_per_test']} / "
        f"{row['inject_bitwise_ms_per_test']} / {row['count_ms_per_test']:.3f}"
        " ms); plain counts at the kernel points equal; no flip in the "
        "guardband; PC 19 counts grow over 0.92/0.90/0.88 V "
        f"{grow}; zeros > ones at 0.88 V ({z} > {o}); PC 18 observed rate "
        f"{observed:.4e} vs model {expected:.4e}; PC 0 @ 0.83 V {deep:.4f}; "
        f"transient batches {transient.fault_counts}")
    torch.cuda.empty_cache()
    return row, k5


def segments_phase(dev):
    """The segments engine (one K5/K6 launch per segment) against the
    arena engine (one K1/K2 launch) over the generate() cell's KV cache:
    llama3.2-3b, batch 4, max_len 1024, 448 MiB over the 16-PC domain,
    filled from a seeded generator."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.core.injection import inject_group
    from repro_torch.kernels import _build
    from repro_torch.models.base import get_arch, spec_avals

    bundle = get_arch("llama3.2-3b")
    avals = spec_avals(bundle.module.cache_specs(bundle.cfg, B, MAX_LEN))
    gen = torch.Generator(device=dev).manual_seed(9)
    tree = pytree.tree_map(lambda a: torch.randn(
        a.shape, generator=gen, device=dev).to(a.dtype)
        if a.dtype.is_floating_point else torch.randint(
            -1, MAX_LEN, a.shape, generator=gen, device=dev,
            dtype=a.dtype), avals)
    report, launches = {}, {"segment_bitflip": 0, "segment_ecc": 0}
    for label, v, ecc, method in (("word", V_DENSE, False, "word"),
                                  ("bitwise", V_BITWISE, False, "bitwise"),
                                  ("ecc", V_DENSE_ECC, True, "word"),
                                  (f"ecc_{V_FAULTY}", V_FAULTY, True, "word")):
        plan = plan_at(v, ecc)
        placement = plan.place({"kv_cache": avals})["kv_cache"]
        fmap = plan.fault_map()
        n_seg = sum(len(lp.segments) for lp in placement.leaves)
        _build.reset_launch_counts()
        seg, bad_s = inject_group(tree, placement, fmap, method=method,
                                  engine="segments")
        after_seg = _build.launch_counts()
        arena, bad_a = inject_group(tree, placement, fmap, method=method)
        after = _build.launch_counts()
        seg_lib, arena_lib = (("segment_ecc", "arena_ecc") if ecc
                              else ("segment_bitflip", "arena_bitflip"))
        if after_seg[seg_lib] != n_seg or after[arena_lib] != 1:
            raise AssertionError(
                f"segments[{label}]: {after_seg[seg_lib]} {seg_lib} "
                f"launches for {n_seg} segments, {after[arena_lib]} "
                f"{arena_lib}")
        launches[seg_lib] += after_seg[seg_lib]
        changed = 0
        for (path, a), (_, b_), (_, x) in zip(
                pytree.flatten_with_path(seg), pytree.flatten_with_path(arena),
                pytree.flatten_with_path(tree)):
            if not bits_equal(a, b_):
                raise AssertionError(f"segments[{label}] {pytree.keystr(path)}"
                                     ": segments engine != arena engine")
            changed += int((a.view(torch.int16 if a.element_size() == 2
                                   else torch.int32)
                            != x.view(torch.int16 if x.element_size() == 2
                                      else torch.int32)).sum())
        if int(bad_s) != int(bad_a):
            raise AssertionError(f"segments[{label}]: {int(bad_s)} != arena "
                                 f"{int(bad_a)} uncorrectable codewords")
        if changed == 0 and v <= V_DENSE:
            raise AssertionError(f"segments[{label}]: no element changed")
        report[label] = dict(voltage=v, segments=n_seg, elements_changed=changed,
                             uncorrectable=int(bad_s))
        log(f"segments[{label}] @ {v} V: {n_seg} segments ({n_seg} "
            f"{seg_lib} launches, 1 {arena_lib}) == arena engine on bits"
            + (f" and uncorrectable counts ({int(bad_s)})" if ecc else "")
            + f"; {changed} cache elements changed")
        del seg, arena
    del tree
    torch.cuda.empty_cache()
    return report, launches


def governor_phase(dev, bundle, cfg, params):
    """generate() under the admission governor at full width: the
    governor admits the 448 MiB cache at a voltage below the guardband,
    and the tokens equal the fixed-voltage run at that voltage."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models.base import spec_avals
    from repro_torch.serving.engine import ServeConfig, generate

    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
    plan = plan_at(V_FAULTY)
    gov = plan.make_governor("kv", mode="rate",
                             tolerable_rate=GOV_TOLERABLE_RATE)
    avals = spec_avals(bundle.module.cache_specs(cfg, B, MAX_LEN))
    kv_bytes = plan.place({"kv_cache": avals})["kv_cache"].total_words * 4
    admitted = gov.admit(kv_bytes)
    if not 0.88 - 1e-6 < admitted < 0.98 - 1e-6:
        raise AssertionError(f"governor admitted {admitted} V")
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW, undervolt=plan,
                     kv_injection="read")
    _build.reset_launch_counts()          # the governed path starts here
    timings = {}
    governed = generate(bundle, cfg, params, {"tokens": prompts},
                        dataclasses.replace(sc, governor=gov), device=dev,
                        timings=timings).cpu()
    launches = _build.launch_counts()     # ... and ends here
    fixed = generate(bundle, cfg, params, {"tokens": prompts},
                     dataclasses.replace(sc, kv_voltage=admitted),
                     device=dev).cpu()
    if not torch.equal(governed, fixed):
        raise AssertionError(f"governor: tokens != the fixed {admitted} V "
                             "run")
    if launches["faulty_decode"] <= 0:
        raise AssertionError("governor: the read path launched no K3")
    log(f"governor (mode rate, tolerable rate {GOV_TOLERABLE_RATE}, 16-PC "
        f"plan) admitted "
        f"{admitted} V for {kv_bytes} bytes; generate(governor=...) tokens "
        f"== generate(kv_voltage={admitted}); decode "
        f"{timings['decode'] / (NEW - 1) * 1e3:.2f} ms/token; launches "
        f"{launches}")
    return dict(tolerable_rate=GOV_TOLERABLE_RATE, kv_bytes=kv_bytes,
                admitted=admitted,
                launches=launches, decode_ms_per_token=timings["decode"]
                / (NEW - 1) * 1e3)


def scheduler_traffic(vocab):
    """8 requests: distinct prompt lengths 96..384, 16..48 new tokens,
    tiers alternating cheap / critical; requests 1 and 5 share a
    256-token prompt prefix."""
    import numpy as np
    rng = np.random.RandomState(6)
    prefix = rng.randint(0, vocab, (SHARED_PREFIX,))
    out = []
    for i, (n, m) in enumerate(zip(SCHED_PROMPTS, SCHED_NEW)):
        toks = rng.randint(0, vocab, (n,))
        if i in (1, 5):
            toks[:SHARED_PREFIX] = prefix
        out.append((i, toks.astype("int32"), m,
                    "critical" if i % 2 else "cheap"))
    return out


def scheduler_phases(dev, bundle, cfg, params):
    """The scheduler's main path at full width: every served request's
    tokens equal its solo generate() replay on its own pages."""
    import numpy as np
    import torch
    from repro_torch.core.domains import CapacityError
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request)

    reqs = scheduler_traffic(cfg.vocab)

    def serve(label, plan, mode="auto", clean_traffic=False):
        """Serve the traffic; undervolted pools take every request at the
        cheap tier without prefix sharing (see the critical check)."""
        sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=16, undervolt=plan,
                         kv_injection=mode, prefill_chunk=CHUNK,
                         share_prefix=clean_traffic)
        sched = ContinuousBatchingScheduler(
            bundle, cfg, params, sc, num_slots=SLOTS, num_pages=SCHED_PAGES,
            page_slots=PAGE_SLOTS, device=dev)
        for rid, toks, n, tier in reqs:
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                                 tier=tier if clean_traffic else "cheap"))
        before = _build.launch_counts()["paged_decode"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sched.run()
        wall = time.perf_counter() - t0
        k4 = _build.launch_counts()["paged_decode"] - before
        if k4 != cfg.n_layers * sched.steps:
            raise AssertionError(f"sched[{label}]: {k4} K4 launches in "
                                 f"{sched.steps} steps, not {cfg.n_layers} "
                                 "per step")
        toks = {rid: res[rid].tokens for rid, *_ in reqs}
        for rid, _, n, _ in reqs:
            t = toks[rid]
            if t.shape != (1, n) or t.min() < 0 or t.max() >= cfg.vocab:
                raise AssertionError(f"sched[{label}] {rid}: bad tokens "
                                     f"{t.shape}")
        n_tok = sum(t.shape[1] for t in toks.values())
        dec = sched.step_seconds["decode"]
        mixed = sched.step_seconds["mixed"]
        ttft = [res[rid].ttft_steps for rid, *_ in reqs]
        st = sched.stats
        row = dict(steps=sched.steps, decode_steps=len(dec),
                   mixed_steps=len(mixed),
                   decode_step_ms=1e3 * float(np.mean(dec)) if dec else None,
                   mixed_step_ms=(1e3 * float(np.mean(mixed))
                                  if mixed else None),
                   wall_s=wall, tokens=n_tok, tokens_per_s=n_tok / wall,
                   peak_active=sched.peak_active, ttft_steps_mean=float(
                       np.mean(ttft)), ttft_steps_max=int(max(ttft)),
                   pages_shared=int(max(res[r].pages_shared
                                        for r, *_ in reqs)),
                   shared_pages=st["shared_pages"],
                   k4_launches=k4, k4_per_step=k4 / sched.steps,
                   mode=sched.mode if sched.active else "clean")
        log(f"sched[{label}] mode={row['mode']}: {sched.steps} steps "
            f"({len(mixed)} mixed at {row['mixed_step_ms']:.1f} ms, "
            f"{len(dec)} decode-only at {row['decode_step_ms']:.1f} ms), "
            f"{n_tok / wall:.1f} tokens/s, peak active {sched.peak_active}, "
            f"TTFT {row['ttft_steps_mean']:.2f} steps (max "
            f"{row['ttft_steps_max']}), shared pages "
            f"{row['pages_shared']}, K4 {k4} launches = "
            f"{cfg.n_layers} x {sched.steps} steps")
        return sc, res, toks, row

    def replay(label, sc, res, clean=False):
        for rid, toks, n, _ in reqs:
            ref = generate(bundle, cfg, params,
                           {"tokens": torch.from_numpy(toks)[None]},
                           dataclasses.replace(
                               sc, max_new_tokens=n,
                               kv_tile=PAGE_SLOTS if clean else None),
                           device=dev,
                           kv_placement=(None if clean
                                         else res[rid].placement))
            if not np.array_equal(ref.cpu().numpy(), res[rid].tokens):
                agree = float((ref.cpu().numpy() == res[rid].tokens).mean())
                raise AssertionError(
                    f"sched[{label}] request {rid}: served tokens != its "
                    f"solo generate() replay (share equal {agree:.3f})")
        log(f"sched[{label}]: every request == its solo "
            + ("clean generate() at the page tile" if clean
               else "generate(kv_placement=...) replay"))

    _build.reset_launch_counts()          # the scheduler's path starts here
    phases, toks = {}, {}
    sc, res, toks["clean"], phases["clean"] = serve("clean", None,
                                                    clean_traffic=True)
    if phases["clean"]["pages_shared"] < 1:
        raise AssertionError("clean traffic shared no prefix page")
    replay("clean", sc, res, clean=True)
    for key, label, v, ecc, mode in (
            ("0.91_read", "0.91V read", V_FAULTY, False, "read"),
            ("dense_read", f"{V_DENSE}V read", V_DENSE, False, "read"),
            ("dense_write", f"{V_DENSE}V write", V_DENSE, False, "write"),
            ("dense_ecc_read", f"{V_DENSE_ECC}V ECC read", V_DENSE_ECC,
             True, "read"),
            ("dense_ecc_write", f"{V_DENSE_ECC}V ECC write", V_DENSE_ECC,
             True, "write")):
        sc, res, toks[key], phases[key] = serve(label, plan_at(v, ecc), mode)
        replay(label, sc, res)
    _, _, toks["nofault"], phases["nofault"] = serve(
        f"{V_NO_FAULT}V read (no fault)", plan_at(V_NO_FAULT), "read")
    k4_total = _build.launch_counts()["paged_decode"]   # ... and ends here
    for a, b in (("dense_read", "dense_write"),
                 ("dense_ecc_read", "dense_ecc_write")):
        if any(not np.array_equal(toks[a][r], toks[b][r]) for r in toks[a]):
            raise AssertionError(f"sched tokens: {a} != {b}")
    agree = {}
    for key in ("0.91_read", "dense_read", "dense_ecc_read"):
        agree[f"{key}_vs_nofault"] = float(np.mean(np.concatenate(
            [(toks[key][r] == toks["nofault"][r]).reshape(-1)
             for r in toks[key]])))
    for key in ("dense_read", "dense_ecc_read"):
        if agree[f"{key}_vs_nofault"] == 1.0:
            raise AssertionError(f"sched tokens: {key} equal the no-fault "
                                 "run's: no fault reached a token")
    log(f"sched tokens: read == write at {V_DENSE} V and {V_DENSE_ECC} V "
        f"ECC, each unlike the no-fault run; share equal: {agree}")

    # Weak-avoiding tiers on an undervolted full-width pool: a page id
    # spans 28 layers x K/V x 16 DRAM rows, so every page overlaps a weak
    # row (ROADMAP F3) and a critical request can only be refused, as a
    # typed CapacityError.
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=2,
                     undervolt=plan_at(V_FAULTY), prefill_chunk=CHUNK)
    sched = ContinuousBatchingScheduler(
        bundle, cfg, params, sc, num_slots=SLOTS, num_pages=SCHED_PAGES,
        page_slots=PAGE_SLOTS, device=dev)
    sched.submit(Request(rid="crit", tokens=reqs[0][1], max_new_tokens=2,
                         tier="critical"))
    weak, n_pages = sched.pool.num_weak_pages, sched.pool.num_pages
    try:
        sched.run()
        refused = None
    except CapacityError as e:
        refused = e
    if (refused is None) != (weak < n_pages):
        raise AssertionError(f"critical tier with {weak} of {n_pages} pages "
                             f"weak: {'refused' if refused else 'served'}")
    log(f"critical tier at {V_FAULTY} V: {weak} of {n_pages} pages weak, "
        + (f"refused with CapacityError ({refused})" if refused
           else "served"))
    torch.cuda.empty_cache()
    return k4_total, phases, agree


def small_input_check(dev):
    """Reduced llama3.2-3b in float32: the card's tokens equal the CPU's
    (plain versions) in clean, read and ECC read modes."""
    import torch
    from repro_torch.core.domains import MemoryDomain
    from repro_torch.core.hbm import VCU128
    from repro_torch.models.base import get_arch, init_params
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.training.undervolt import UndervoltPlan
    bundle = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(bundle.reduced, dtype=torch.float32)
    params = init_params(bundle.module.param_specs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    from repro_torch.core import pytree
    params_dev = pytree.tree_map(lambda t: t.to(dev), params)
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(3))
    for v, ecc, mode in ((None, False, "auto"), (0.88, False, "read"),
                         (0.88, False, "write"), (0.88, True, "read")):
        plan = None if v is None else UndervoltPlan(
            domains={"kv": MemoryDomain("kv", v, tuple(range(32)), ecc=ecc)},
            policy={"kv_cache": "kv"}, geometry=VCU128)
        sc = ServeConfig(max_len=40, max_new_tokens=8, undervolt=plan,
                         kv_injection=mode)
        cpu = generate(bundle, cfg, params, {"tokens": tokens}, sc,
                       device="cpu")
        gpu = generate(bundle, cfg, params_dev, {"tokens": tokens}, sc,
                       device=dev).cpu()
        if not torch.equal(cpu, gpu):
            raise AssertionError(f"reduced f32 {v} V ecc={ecc} {mode}: card "
                                 f"tokens {gpu.tolist()} != CPU "
                                 f"{cpu.tolist()}")
    log("small input: reduced llama3.2-3b f32 tokens equal on card and CPU "
        "(clean, 0.88 V read/write, 0.88 V ECC read)")


def full_width_model(dev):
    """llama3.2-3b at full width, bf16, weights from a seeded generator."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.models.base import get_arch, init_params
    bundle = get_arch("llama3.2-3b")
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = init_params(bundle.module.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.leaves(params))
    log(f"llama3.2-3b full width: {n_params / 1e9:.3f} B params "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, bf16) initialised "
        f"in {time.perf_counter() - t0:.1f} s")
    return bundle, cfg, params


def serving_phases(dev, bundle, cfg, params):
    """The main path through generate() at full width, with launch
    counts."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeConfig, generate

    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))

    def run(label, plan, mode="auto"):
        sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW, undervolt=plan,
                         kv_injection=mode)
        before = _build.launch_counts()
        wgmma_before = _build.variant_counts("flash_prefill").get("wgmma", 0)
        gated_before = _build.variant_counts("rglru_scan").get("gated", 0)
        timings = {}
        toks = generate(bundle, cfg, params, {"tokens": prompts}, sc,
                        device=dev, timings=timings)
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        wgmma = (_build.variant_counts("flash_prefill").get("wgmma", 0)
                 - wgmma_before)
        gated = (_build.variant_counts("rglru_scan").get("gated", 0)
                 - gated_before)
        if toks.shape != (B, NEW) or int(toks.min()) < 0 or int(
                toks.max()) >= cfg.vocab:
            raise AssertionError(f"{label}: bad token tensor {toks.shape}")
        dec_tok = timings["decode"] / (NEW - 1)
        log(f"serve[{label}] mode={timings['mode']}: prefill "
            f"{timings['prefill'] * 1e3:.1f} ms, inject "
            f"{timings['inject'] * 1e3:.2f} ms, decode "
            f"{dec_tok * 1e3:.2f} ms/token, {B * (NEW - 1) / timings['decode']:.1f} "
            f"tokens/s (batch {B}), launches {launches}")
        return toks.cpu(), dict(timings, launches=launches,
                                decode_ms_per_token=dec_tok * 1e3,
                                tokens_per_s=B * (NEW - 1) / timings["decode"])

    def agreement(a, b) -> float:
        return float((a == b).float().mean())

    # warm the allocator and the library handles outside the record
    generate(bundle, cfg, params, {"tokens": prompts[:, :8]},
             ServeConfig(max_len=64, max_new_tokens=2), device=dev)
    _build.reset_launch_counts()          # the main path starts here
    phases, toks = {}, {}
    for key, label, plan, mode in (
            ("clean", "clean", None, "auto"),
            ("0.98", "0.98V", plan_at(0.98), "auto"),
            ("0.91_read", "0.91V read", plan_at(V_FAULTY), "read"),
            ("0.91_write", "0.91V write", plan_at(V_FAULTY), "write"),
            ("0.91_ecc_read", "0.91V ECC read", plan_at(V_FAULTY, True),
             "read"),
            ("0.91_ecc_write", "0.91V ECC write", plan_at(V_FAULTY, True),
             "write"),
            ("nofault", f"{V_NO_FAULT}V read (no fault)",
             plan_at(V_NO_FAULT), "read"),
            ("dense_read", f"{V_DENSE}V read", plan_at(V_DENSE), "read"),
            ("dense_write", f"{V_DENSE}V write", plan_at(V_DENSE), "write"),
            ("dense_ecc_read", f"{V_DENSE_ECC}V ECC read",
             plan_at(V_DENSE_ECC, True), "read"),
            ("dense_ecc_write", f"{V_DENSE_ECC}V ECC write",
             plan_at(V_DENSE_ECC, True), "write"),
            ("mid_ecc_read", f"{V_MID_ECC}V ECC read",
             plan_at(V_MID_ECC, True), "read"),
            ("mid_ecc_write", f"{V_MID_ECC}V ECC write",
             plan_at(V_MID_ECC, True), "write")):
        toks[key], phases[key] = run(label, plan, mode)
    counts = _build.launch_counts()        # ... and ends here
    for a, b, what in (("0.98", "clean", "0.98 V != clean"),
                       ("0.91_read", "0.91_write", "0.91 V read != write"),
                       ("0.91_ecc_read", "0.91_ecc_write",
                        "0.91 V ECC read != write"),
                       ("dense_read", "dense_write",
                        f"{V_DENSE} V read != write"),
                       ("dense_ecc_read", "dense_ecc_write",
                        f"{V_DENSE_ECC} V ECC read != write"),
                       ("mid_ecc_read", "mid_ecc_write",
                        f"{V_MID_ECC} V ECC read != write")):
        if not torch.equal(toks[a], toks[b]):
            raise AssertionError(f"tokens: {what}")
    for key in ("dense_read", "dense_ecc_read", "mid_ecc_read"):
        if torch.equal(toks[key], toks["nofault"]):
            raise AssertionError(f"tokens: {key} equal the no-fault run's: "
                                 "no fault reached a token")
    agree = {f"{a}_vs_{b}": agreement(toks[a], toks[b]) for a, b in (
        ("nofault", "clean"), ("0.91_read", "clean"),
        ("0.91_read", "nofault"), ("0.91_ecc_read", "nofault"),
        ("dense_read", "nofault"), ("dense_ecc_read", "nofault"),
        ("mid_ecc_read", "nofault"))}
    # Token 0 is what argmax gives for all-NaN logits: its share says how
    # far stuck exponent bits turned a run's decode into NaN.
    agree.update({f"{k}_token0_share": float((toks[k] == 0).float().mean())
                  for k in ("nofault", "0.91_read", "dense_read",
                            "dense_ecc_read", "mid_ecc_read")})
    log(f"tokens: 0.98 V == clean; read == write at 0.91 V, 0.91 V ECC, "
        f"{V_DENSE} V, {V_DENSE_ECC} V ECC and {V_MID_ECC} V ECC, each "
        f"unlike the no-fault K3 run; share of tokens equal: {agree}")
    for name in ("arena_bitflip", "arena_ecc", "faulty_decode"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "generate() path")
    log(f"generate() path launches: {counts}")
    torch.cuda.empty_cache()
    return counts, phases, agree


def row_invariance_check(dev):
    """The finding behind layers.row_blocked, measured: a bf16 projection
    at the full-width shape (K = N = 3072) and a row mean, each row's bits
    for a batch of M rows against M = 1; then the row-blocked forms, which
    must agree for every M."""
    import torch
    from repro_torch.models import layers
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((256, 3072), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((3072, 3072), generator=gen, device=dev).to(
        torch.bfloat16) * 0.02
    report = {}
    for name, fn in (("matmul", lambda a: a @ w),
                     ("row_mean", lambda a: a.float().square().mean(-1))):
        one = torch.cat([fn(x[i:i + 1]) for i in range(8)])
        blocked_one = torch.cat([layers.row_blocked(fn, x[i:i + 1])
                                 for i in range(8)])
        for m in (4, 64, 256):
            r = min(m, 8)
            got = fn(x[:m])[:r]
            report[f"{name}_M{m}_rows_differing_from_M1"] = int(
                (got != one[:r]).reshape(r, -1).any(-1).sum())
            blocked = layers.row_blocked(fn, x[:m])[:r]
            if not bits_equal(blocked, blocked_one[:r]):
                raise AssertionError(f"row_blocked {name}: M={m} rows differ "
                                     "from M=1")
    log(f"row invariance (of the first min(M, 8) rows, bits vs M=1): "
        f"{report}; row_blocked: "
        "bit-equal for every M")
    return report


def argmax_nan_check(dev):
    import torch
    rows = torch.tensor([[1.0, float("nan"), 5.0, float("nan")],
                         [3.0, 7.0, 7.0, 1.0],
                         [float("inf"), float("nan"), 2.0, 2.0]], device=dev)
    got = torch.argmax(rows, dim=-1).cpu().tolist()
    if got != [1, 1, 1]:
        raise AssertionError(f"CUDA argmax {got}: not the first NaN/maximum "
                             "like jnp.argmax")
    log("CUDA argmax takes the first NaN / first maximum, like jnp.argmax")


# ---------------------------------------------------------------------------
# recurrentgemma-9b: prefill flash attention (K7), the RG-LRU scan (K8), and
# the hybrid family served through generate() and the state-arena scheduler
# ---------------------------------------------------------------------------


def hybrid_kernel_phase(dev):
    """K7 and K8 against their plain versions at the generate() cell's
    shapes (and more shapes each), timed on the device beside their host
    pace and bounds, rows at B = 1 held to the same rows at B = 4 on bits;
    K7 also beside SDPA and beside its SIMT variant, K8's gated entry
    beside the gate ops and K8's scan entry it replaces."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.flash_attention import (
        band_pairs, flash_attention_fwd, pick_variant)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rglru import ops as rops
    from repro_torch.kernels.rglru.ref import (rglru_gated_scan_ref,
                                               rglru_gates_ref, rglru_scan_ref)
    from repro_torch.models.base import get_arch

    cfg = get_arch("recurrentgemma-9b").cfg
    H, KH, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    gen = torch.Generator(device=dev).manual_seed(11)
    variants = {}
    for label, b, s, dtype, window in (
            ("bf16_window", HYB_B, HYB_PROMPT, torch.bfloat16, W),
            ("bf16_admission", 1, max(HYB_SCHED_PROMPTS), torch.bfloat16, W),
            ("f32_causal", HYB_B, 1024, torch.float32, 0)):
        q = torch.randn((b, H, s, D), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, KH, s, D), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, KH, s, D), generator=gen, device=dev).to(dtype)
        variant = pick_variant(dtype, D)
        if label == "f32_causal" and variant != "tf32x3":
            raise AssertionError(f"K7 {label}: float32 at head_dim {D} picks "
                                 f"{variant}, not tf32x3")

        def k7(q=q, k=k, v=v, window=window):
            return fops.flash_attention(q, k, v, causal=True, window=window)
        before = _build.variant_counts("flash_prefill")
        got = k7()
        after = _build.variant_counts("flash_prefill")
        served = {key: n - before.get(key, 0) for key, n in after.items()
                  if n != before.get(key, 0)}
        if served != {variant: 1}:
            raise AssertionError(f"K7 {label}: launched {served}, not one "
                                 f"{variant} launch")
        ref = attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        if dtype == torch.bfloat16:
            err = k3_compare(f"K7 {label}", got, ref)
        else:
            err = float((got - ref).abs().max())
            over = (got - ref).abs() > 1e-5 + 1e-5 * ref.abs()
            if bool(over.any()):
                raise AssertionError(f"K7 {label}: {int(over.sum())} outputs "
                                     f"outside 1e-5 + 1e-5*|ref| (max abs "
                                     f"err {err})")
        del ref
        extra = {}
        if b > 1:
            # a row's bits do not depend on the batch it is launched in
            for i in (0, b - 1):
                one = fops.flash_attention(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1], causal=True,
                                           window=window)
                if not bits_equal(one, got[i:i + 1]):
                    raise AssertionError(f"K7 {label}: batch row {i} "
                                         "launched alone != the same rows "
                                         f"at B = {b}")
            extra["rows_b1_equal_b4"] = True
            log(f"K7 {label}: batch rows 0 and {b - 1} launched at B = 1 "
                f"equal the same rows at B = {b} on bits")
        ms = cuda_ms(k7, reps=5, queue_s=QUEUE_S)
        host_ms = cuda_ms(k7, reps=5)
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, causal=True,
                                                 window=window),
                           reps=1, warmup=0)
        # SDPA over the same band: KV head expanded, boolean mask (the port
        # never calls it); and, for scale, SDPA's causal kernel over the
        # whole triangle
        i = torch.arange(s, device=dev)
        delta = i[:, None] - i[None, :]
        allowed = delta >= 0
        if window > 0:
            allowed &= delta < window
        ke, ve = k.expand(b, H, s, D), v.expand(b, H, s, D)
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=allowed), reps=5, queue_s=QUEUE_S)
        sdpa_causal_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True), reps=5, queue_s=QUEUE_S)
        if label in ("bf16_window", "f32_causal"):
            # the SIMT variant at the same shape, for comparison
            extra["simt_ms"] = cuda_ms(lambda: flash_attention_fwd(
                q, k, v, sk=s, causal=True, window=window,
                scale=float(D ** -0.5), variant="simt"), reps=3,
                queue_s=QUEUE_S)
        pairs = b * H * band_pairs(s, s, True, window)
        flops = 4 * pairs * D
        io = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        if dtype == torch.bfloat16:
            b_ms, b_by = bound(io, bf16_flops=flops)
        else:
            # tf32x3 runs three TF32 products per float32 one on the
            # tensor cores; the float32 CUDA cores' bound beside it
            b_ms, b_by = bound(io, tf32_flops=3 * flops)
            extra["bound_f32_cores_ms"] = bound(io, flops=flops)[0]
        variants[label] = dict(max_abs_err=err, ms=ms, host_ms=host_ms,
                               plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, library_ms=sdpa_ms,
                               sdpa_causal_ms=sdpa_causal_ms,
                               variant=variant, flops=flops,
                               shape=[b, H, KH, s, D], window=window, **extra)
        log(f"K7 flash_attention[{label}] {variant} (B={b}, H={H}, KH={KH}, "
            f"S={s}, D={D}, causal, window {window}): max abs err {err:.3g} "
            f"vs plain; {ms:.4f} ms on the device, {host_ms:.4f} ms at the "
            f"eager host pace (bound {b_ms:.4f} ms by {b_by}, {flops:.3e} "
            f"flops, {flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.2f} ms; "
            f"SDPA over the band {sdpa_ms:.4f} ms, causal SDPA over the "
            f"whole triangle {sdpa_causal_ms:.4f} ms"
            + (f"; SIMT variant {extra['simt_ms']:.4f} ms" if "simt_ms" in
               extra else "")
            + (f"; float32 CUDA-core bound {extra['bound_f32_cores_ms']:.4f}"
               " ms" if "bound_f32_cores_ms" in extra else "") + ")")
        del q, k, v, ke, ve, got
        torch.cuda.empty_cache()
    main = variants.pop("bf16_window")
    k7 = dict(name="flash_attention", route="cuda",
              source="src/repro_torch/kernels/csrc/flash_prefill.cu",
              replaces="src/repro/kernels/flash_attention/flash_attention.py:74",
              **main, variants=variants)

    R = cfg.lru_width
    variants = {}

    def k8_check(label, got, want):
        if not bits_equal(got[1], got[0][:, -1]):
            raise AssertionError(f"K8 {label}: h_last != h at step S - 1")
        err = 0.0
        for g, w in zip(got, want):
            err = max(err, float((g - w).abs().max()))
            over = (g - w).abs() > 1e-5 + 1e-5 * w.abs()
            if bool(over.any()):
                raise AssertionError(f"K8 {label}: {int(over.sum())} outputs "
                                     f"outside 1e-5 + 1e-5*|ref| (max abs "
                                     f"err {err})")
        return err

    def k8_rows(label, fn, got):
        # a row's bits do not depend on the batch it is launched in
        for i in (0, HYB_B - 1):
            one = fn(slice(i, i + 1))
            if not (bits_equal(one[0], got[0][i:i + 1])
                    and bits_equal(one[1], got[1][i:i + 1])):
                raise AssertionError(f"K8 {label}: batch row {i} launched "
                                     f"alone != the same row at B = {HYB_B}")

    def k8_served(label, call, variant):
        before = _build.variant_counts("rglru_scan")
        out = call()
        after = _build.variant_counts("rglru_scan")
        served = {key: n - before.get(key, 0) for key, n in after.items()
                  if n != before.get(key, 0)}
        if served != {variant: 1}:
            raise AssertionError(f"K8 {label}: launched {served}, not one "
                                 f"{variant} launch")
        return out

    for label, s in (("prefill", HYB_PROMPT), ("decode", 1)):
        # the TPU kernel's counterpart: a and b given
        a = 0.8 + 0.199 * torch.rand((HYB_B, s, R), generator=gen,
                                     device=dev)
        b = 0.1 * torch.randn((HYB_B, s, R), generator=gen, device=dev)
        h0 = torch.randn((HYB_B, R), generator=gen, device=dev)
        got = k8_served(label, lambda: rops.rglru_scan(a, b, h0), "scan")
        err = k8_check(label, got, rglru_scan_ref(a, b, h0))
        k8_rows(label, lambda i: rops.rglru_scan(a[i], b[i], h0[i]), got)
        ms = cuda_ms(lambda: rops.rglru_scan(a, b, h0), reps=10,
                     queue_s=QUEUE_S)
        host_ms = cuda_ms(lambda: rops.rglru_scan(a, b, h0), reps=10)
        plain_ms = cuda_ms(lambda: rglru_scan_ref(a, b, h0), reps=1,
                           warmup=0)
        nbytes = 4 * (3 * a.numel() + 2 * h0.numel())
        b_ms, b_by = bound(nbytes, flops=2 * a.numel())
        variants[f"scan_{label}"] = dict(
            max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=nbytes,
            variant="scan", shape=[HYB_B, s, R])
        log(f"K8 rglru_scan[{label}] scan (B={HYB_B}, S={s}, R={R}, h0 != 0): "
            f"max abs err {err:.3g} vs plain; {ms:.4f} ms on the device, "
            f"{host_ms:.4f} ms at the eager host pace (bound {b_ms:.4f} ms "
            f"by {b_by}, {nbytes} bytes; plain {plain_ms:.2f} ms); rows 0 "
            f"and {HYB_B - 1} at B = 1 equal B = {HYB_B} on bits")
        del a, b, got

        # the model's RG-LRU, gate math fused: gates and y as the model
        # hands them over (y in the model dtype), lam around its init
        r_g = torch.sigmoid(torch.randn((HYB_B, s, R), generator=gen,
                                        device=dev))
        i_g = torch.sigmoid(torch.randn((HYB_B, s, R), generator=gen,
                                        device=dev))
        y = torch.randn((HYB_B, s, R), generator=gen, device=dev).to(
            cfg.dtype)
        lam = -4.38 + 0.5 * torch.randn((R,), generator=gen, device=dev)
        got = k8_served(f"gated {label}", lambda: rops.rglru_gated_scan(
            r_g, i_g, y, lam, h0), "gated")
        err = k8_check(f"gated {label}", got,
                       rglru_gated_scan_ref(r_g, i_g, y, lam, h0))
        k8_rows(f"gated {label}", lambda i: rops.rglru_gated_scan(
            r_g[i], i_g[i], y[i], lam, h0[i]), got)
        # the model's call writes the last state over the carried one
        h_state = h0.clone()
        h_seq, h_last = rops.rglru_gated_scan(r_g, i_g, y, lam, h_state,
                                              h_last=h_state)
        if not (h_last is h_state and bits_equal(h_seq, got[0])
                and bits_equal(h_state, got[1])):
            raise AssertionError(f"K8 gated {label}: h_last written over h0 "
                                 "differs from a fresh h_last")

        def gated():
            return rops.rglru_gated_scan(r_g, i_g, y, lam, h_state,
                                         h_last=h_state)

        def unfused():
            return rops.rglru_scan(*rglru_gates_ref(r_g, i_g, y, lam), h0)
        ms = cuda_ms(gated, reps=10, queue_s=QUEUE_S)
        host_ms = cuda_ms(gated, reps=10)
        unfused_ms = cuda_ms(unfused, reps=10, queue_s=QUEUE_S)
        unfused_host_ms = cuda_ms(unfused, reps=10)
        plain_ms = cuda_ms(lambda: rglru_gated_scan_ref(r_g, i_g, y, lam,
                                                        h0),
                           reps=1, warmup=0)
        if ms >= unfused_ms:
            raise AssertionError(f"K8 gated {label}: {ms:.4f} ms, not below "
                                 "the gate ops and K8's scan "
                                 f"({unfused_ms:.4f} ms)")
        nbytes = ((8 + y.element_size() + 4) * r_g.numel() + 4 * R
                  + 8 * h0.numel())
        # per element: the scan's multiply-add and the gate math's ops
        b_ms, b_by = bound(nbytes, flops=12 * r_g.numel())
        variants[f"gated_{label}"] = dict(
            max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None, bytes=nbytes,
            unfused_ms=unfused_ms, unfused_host_ms=unfused_host_ms,
            variant="gated", shape=[HYB_B, s, R])
        log(f"K8 rglru_scan[{label}] gated (B={HYB_B}, S={s}, R={R}, y "
            f"{str(y.dtype)[6:]}): max abs err {err:.3g} vs plain; {ms:.4f} "
            f"ms on the device, {host_ms:.4f} ms at the eager host pace "
            f"(bound {b_ms:.4f} ms by {b_by}, {nbytes} bytes; the gate ops "
            f"and K8's scan {unfused_ms:.4f} ms on the device, "
            f"{unfused_host_ms:.4f} at the host pace; plain {plain_ms:.2f} "
            f"ms); rows 0 and {HYB_B - 1} at B = 1 equal B = {HYB_B} on "
            "bits; h_last written over h0 equals a fresh one")
        del r_g, i_g, y, h0, got, h_seq
    # the headline is the entry the main path launches; the TPU kernel's
    # counterpart (the scan entry) stands under variants
    main = variants.pop("gated_prefill")
    k8 = dict(name="rglru_scan", route="cuda",
              source="src/repro_torch/kernels/csrc/rglru_scan.cu",
              replaces="src/repro/kernels/rglru/rglru.py:50",
              **main, variants=variants)
    torch.cuda.empty_cache()
    return [k7, k8]


def hybrid_small_input_check(dev):
    """Reduced recurrentgemma-9b in float32: prefill logits on the card
    (K7, K8) agree with the CPU's (plain versions) within 1e-4 and greedy
    tokens are equal, clean and with write-path faults.  With ECC, a word
    is corrected or flagged by its stored bits, so the 0.868 V tokens
    hinge on low bits of the cache: this compares card and CPU at these
    seeds; ``scripts/f32_seed_sweep.py`` measures how often it holds at
    others, per float32 K7 variant."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.core.domains import MemoryDomain
    from repro_torch.core.hbm import VCU128
    from repro_torch.kernels import _build
    from repro_torch.models.base import get_arch, init_params
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.training.undervolt import UndervoltPlan
    bundle = get_arch("recurrentgemma-9b")
    cfg = dataclasses.replace(bundle.reduced, dtype=torch.float32)
    params = init_params(bundle.module.param_specs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    params_dev = pytree.tree_map(lambda t: t.to(dev), params)
    tokens = torch.randint(0, cfg.vocab, (2, 13),
                           generator=torch.Generator().manual_seed(3))
    _build.reset_launch_counts()
    gl, _ = bundle.module.prefill(params_dev, {"tokens": tokens.to(dev)},
                                  cfg, 40)
    cl, _ = bundle.module.prefill(params, {"tokens": tokens}, cfg, 40)
    err = float((gl.cpu() - cl).abs().max())
    if err > 1e-4:
        raise AssertionError(f"reduced recurrentgemma f32: card logits differ "
                             f"from the CPU's by {err}")
    counts = _build.launch_counts()
    k7_variants = _build.variant_counts("flash_prefill")
    k8_variants = _build.variant_counts("rglru_scan")
    if (counts["flash_prefill"] == 0 or counts["rglru_scan"] == 0
            or k7_variants != {"tf32x3": counts["flash_prefill"]}
            or k8_variants != {"gated": counts["rglru_scan"]}):
        raise AssertionError(f"reduced recurrentgemma prefill on the card "
                             f"launched {counts}, K7 {k7_variants}, K8 "
                             f"{k8_variants}: not K7 through tf32x3 and K8 "
                             "through its gated entry alone")
    for v, ecc in ((None, False), (0.875, False), (0.868, True)):
        plan = None if v is None else UndervoltPlan(
            domains={"kv": MemoryDomain("kv", v, tuple(range(32)), ecc=ecc)},
            policy={"kv_cache": "kv"}, geometry=VCU128)
        sc = ServeConfig(max_len=40, max_new_tokens=8, undervolt=plan,
                         kv_injection="write")
        cpu = generate(bundle, cfg, params, {"tokens": tokens}, sc,
                       device="cpu")
        gpu = generate(bundle, cfg, params_dev, {"tokens": tokens}, sc,
                       device=dev).cpu()
        if not torch.equal(cpu, gpu):
            raise AssertionError(f"reduced recurrentgemma f32 {v} V ecc={ecc}: "
                                 f"card tokens {gpu.tolist()} != CPU "
                                 f"{cpu.tolist()}")
    log(f"small input: reduced recurrentgemma-9b f32 prefill logits on the "
        f"card (K7 {k7_variants}, K8 {k8_variants}) within {err:.3g} of the "
        "CPU's (bound 1e-4); greedy tokens equal on card and CPU (clean, "
        "0.875 V write, 0.868 V ECC write)")
    return err


def hybrid_model(dev):
    """recurrentgemma-9b at full width, bf16, weights from a seeded
    generator."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.models.base import get_arch, init_params
    bundle = get_arch("recurrentgemma-9b")
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = init_params(bundle.module.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.leaves(params))
    log(f"recurrentgemma-9b full width: {n_params / 1e9:.3f} B params "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, lru {cfg.lru_width}, "
        f"bf16) initialised in {time.perf_counter() - t0:.1f} s")
    return bundle, cfg, params


def hybrid_serving_phases(dev, bundle, cfg, params):
    """The hybrid family through generate() at full width: batch 4, a
    prompt past the local window, with launch counts per phase."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeConfig, generate

    n_rec = cfg.layer_kinds().count("rec")
    n_local = cfg.layer_kinds().count("local")
    prompts = torch.randint(0, cfg.vocab, (HYB_B, HYB_PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))

    def run(label, plan, mode="write"):
        sc = ServeConfig(max_len=HYB_MAX_LEN, max_new_tokens=HYB_NEW,
                         undervolt=plan, kv_injection=mode)
        before = _build.launch_counts()
        wgmma_before = _build.variant_counts("flash_prefill").get("wgmma", 0)
        gated_before = _build.variant_counts("rglru_scan").get("gated", 0)
        timings = {}
        toks = generate(bundle, cfg, params, {"tokens": prompts}, sc,
                        device=dev, timings=timings)
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        wgmma = (_build.variant_counts("flash_prefill").get("wgmma", 0)
                 - wgmma_before)
        gated = (_build.variant_counts("rglru_scan").get("gated", 0)
                 - gated_before)
        if toks.shape != (HYB_B, HYB_NEW) or int(toks.min()) < 0 or int(
                toks.max()) >= cfg.vocab:
            raise AssertionError(f"hybrid {label}: bad tokens {toks.shape}")
        if launches["flash_prefill"] != n_local or wgmma != n_local:
            raise AssertionError(f"hybrid {label}: {launches['flash_prefill']}"
                                 f" K7 launches ({wgmma} wgmma), not {n_local}"
                                 " wgmma launches per prefill")
        if not launches["rglru_scan"] == gated == n_rec * HYB_NEW:
            raise AssertionError(f"hybrid {label}: {launches['rglru_scan']} "
                                 f"K8 launches ({gated} gated), not {n_rec} "
                                 "gated launches per prefill and per decode "
                                 "step")
        dec_tok = timings["decode"] / (HYB_NEW - 1)
        log(f"hybrid serve[{label}] mode={timings['mode']}: prefill "
            f"{timings['prefill'] * 1e3:.1f} ms, inject "
            f"{timings['inject'] * 1e3:.2f} ms, decode {dec_tok * 1e3:.2f} "
            f"ms/token, {HYB_B * (HYB_NEW - 1) / timings['decode']:.1f} "
            f"tokens/s (batch {HYB_B}), launches {launches}")
        return toks.cpu(), dict(
            prefill_ms=timings["prefill"] * 1e3,
            inject_ms=timings["inject"] * 1e3,
            decode_ms_per_token=dec_tok * 1e3,
            tokens_per_s=HYB_B * (HYB_NEW - 1) / timings["decode"],
            mode=timings["mode"], launches=launches)

    # warm the allocator and the library handles outside the record
    generate(bundle, cfg, params, {"tokens": prompts[:, :64]},
             ServeConfig(max_len=128, max_new_tokens=2), device=dev)
    _build.reset_launch_counts()          # the hybrid generate() path starts
    phases, toks = {}, {}
    for key, label, plan, mode in (
            ("clean", "clean", None, "auto"),
            ("0.98", "0.98V", plan_at(0.98), "auto"),
            ("nofault", f"{V_NO_FAULT}V write (no fault)",
             plan_at(V_NO_FAULT), "write"),
            ("0.91_write", "0.91V write", plan_at(V_FAULTY), "write"),
            ("dense_write", f"{V_DENSE}V write", plan_at(V_DENSE), "write"),
            ("dense_rewrite", f"{V_DENSE}V rewrite", plan_at(V_DENSE),
             "rewrite"),
            ("dense_ecc_write", f"{V_DENSE_ECC}V ECC write",
             plan_at(V_DENSE_ECC, True), "write")):
        toks[key], phases[key] = run(label, plan, mode)
    counts = dict(_build.LAUNCHES)        # ... and ends here
    if not torch.equal(toks["0.98"], toks["clean"]):
        raise AssertionError("hybrid tokens: 0.98 V != clean")
    if not torch.equal(toks["dense_write"], toks["dense_rewrite"]):
        raise AssertionError(f"hybrid tokens: {V_DENSE} V write != rewrite")
    for key in ("nofault", "0.91_write", "dense_write", "dense_ecc_write"):
        arena = (phases[key]["launches"]["arena_bitflip"]
                 + phases[key]["launches"]["arena_ecc"])
        if arena != 1:
            raise AssertionError(f"hybrid {key}: {arena} K1/K2 launches for "
                                 "one undervolted write request, not 1")
    differ = {key: float((toks[key] != toks["nofault"]).float().mean())
              for key in ("clean", "0.98", "0.91_write", "dense_write",
                          "dense_ecc_write")}
    log(f"hybrid tokens: 0.98 V == clean, write == rewrite at {V_DENSE} V, "
        f"K7 {n_local} (all wgmma) and K8 {n_rec} (all gated) launches per "
        f"prefill, K8 {n_rec} (all gated) per decode step, one K1/K2 launch "
        f"per write request; share of tokens "
        f"differing from the {V_NO_FAULT} V run: {differ}")
    torch.cuda.empty_cache()
    return counts, phases, differ


def hybrid_scheduler_traffic(vocab):
    import numpy as np
    rng = np.random.RandomState(8)
    return [(i, rng.randint(0, vocab, (n,)).astype("int32"), m)
            for i, (n, m) in enumerate(zip(HYB_SCHED_PROMPTS, HYB_SCHED_NEW))]


def hybrid_scheduler_phases(dev, bundle, cfg, params):
    """The hybrid family through the scheduler front door (the state
    arena): every request's tokens equal its solo generate() replay."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request)
    from repro_torch.serving.statearena import StateArenaScheduler

    reqs = hybrid_scheduler_traffic(cfg.vocab)
    n_rec = cfg.layer_kinds().count("rec")
    counts = {}
    phases = {}
    for key, plan in (("clean", None), ("dense_write", plan_at(V_DENSE))):
        sc = ServeConfig(max_len=HYB_SCHED_MAX_LEN, max_new_tokens=8,
                         undervolt=plan, kv_injection="write")
        sched = ContinuousBatchingScheduler(bundle, cfg, params, sc,
                                            num_slots=HYB_SLOTS, device=dev)
        if not isinstance(sched, StateArenaScheduler):
            raise AssertionError(f"front door gave {type(sched).__name__} "
                                 "for the hybrid family")
        for rid, toks, n in reqs:
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
        torch.cuda.synchronize()
        _build.reset_launch_counts()      # the scheduler path starts here
        t0 = time.perf_counter()
        res = sched.run()
        wall = time.perf_counter() - t0
        launches = _build.launch_counts()  # ... and ends here
        for name, n in _build.LAUNCHES.items():
            counts[name] = counts.get(name, 0) + n
        k7_variants = _build.variant_counts("flash_prefill")
        if set(k7_variants) - {"wgmma"} or sum(
                k7_variants.values()) != launches["flash_prefill"]:
            raise AssertionError(f"sched hybrid {key}: K7 admissions launched "
                                 f"{k7_variants}, not only wgmma")
        k8_variants = _build.variant_counts("rglru_scan")
        if k8_variants != {"gated": launches["rglru_scan"]}:
            raise AssertionError(f"sched hybrid {key}: K8 launched "
                                 f"{k8_variants}, not only gated")
        if launches["rglru_scan"] != n_rec * (sched.steps + len(reqs)):
            raise AssertionError(f"sched hybrid {key}: "
                                 f"{launches['rglru_scan']} K8 launches, not "
                                 f"{n_rec} per step and per admission")
        for rid, toks, n in reqs:
            ref = generate(bundle, cfg, params,
                           {"tokens": torch.from_numpy(toks)[None]},
                           dataclasses.replace(sc, max_new_tokens=n),
                           device=dev,
                           kv_placement=(None if plan is None
                                         else res[rid].placement))
            if not np.array_equal(ref.cpu().numpy(), res[rid].tokens):
                agree = float((ref.cpu().numpy() == res[rid].tokens).mean())
                raise AssertionError(
                    f"sched hybrid {key} request {rid}: served tokens != "
                    f"its solo generate() replay (share equal {agree:.3f})")
        n_tok = sum(res[rid].tokens.shape[1] for rid, *_ in reqs)
        step_ms = 1e3 * float(np.mean(sched.step_seconds["decode"]))
        phases[key] = dict(steps=sched.steps, step_ms=step_ms, wall_s=wall,
                           tokens=n_tok, tokens_per_s=n_tok / wall,
                           peak_active=sched.peak_active,
                           k8_per_step=n_rec, launches=launches)
        log(f"sched hybrid[{key}] (state arena, {HYB_SLOTS} slots, "
            f"{len(reqs)} requests): {sched.steps} steps at {step_ms:.1f} "
            f"ms, {n_tok / wall:.1f} tokens/s (admission prefills "
            f"included), K8 {n_rec} (all gated) per step and per "
            f"admission, K7 "
            f"{launches['flash_prefill']} (all wgmma); every "
            f"request == its solo generate("
            f"{'' if plan is None else 'kv_placement=...'}) replay")
    torch.cuda.empty_cache()
    return counts, phases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all(verbose=True)      # logs each kernel's ptxas -v
    build_s = time.perf_counter() - t0
    log(f"built {len(_build.KERNELS)} kernels (parallel nvcc, sm_90a) in "
        f"{build_s:.1f} s")

    argmax_nan_check(dev)
    row_report = row_invariance_check(dev)
    ops_per_word = dict(OPS_PER_WORD)
    sass = sass_per_word()
    for method, n in sass.items():
        ops_per_word[method] = n["alu"]
    rows = kernel_phases(dev, ops_per_word)
    rows.append(paged_kernel_phase(dev, ops_per_word))
    rows.extend(segment_kernel_phase(dev, ops_per_word))
    sweep_row, k5_sweep = sweep_phase(dev)
    seg_report, seg_launches = segments_phase(dev)
    rows.extend(hybrid_kernel_phase(dev))
    small_input_check(dev)
    hyb_small_err = hybrid_small_input_check(dev)
    bundle, cfg, params = full_width_model(dev)
    counts, phases, agree = serving_phases(dev, bundle, cfg, params)
    governor_row = governor_phase(dev, bundle, cfg, params)
    k4_launches, sched_phases, sched_agree = scheduler_phases(
        dev, bundle, cfg, params)
    del params
    torch.cuda.empty_cache()
    bundle, cfg, params = hybrid_model(dev)
    hyb_counts, hyb_phases, hyb_differ = hybrid_serving_phases(
        dev, bundle, cfg, params)
    hyb_sched_counts, hyb_sched_phases = hybrid_scheduler_phases(
        dev, bundle, cfg, params)
    del params
    for name in set(hyb_counts) | set(hyb_sched_counts):
        if name.startswith(("flash_prefill", "rglru_scan")):
            counts[name] = (hyb_counts.get(name, 0)
                            + hyb_sched_counts.get(name, 0))
    counts["paged_decode"] = k4_launches
    counts["segment_bitflip"] = k5_sweep + seg_launches["segment_bitflip"]
    counts["segment_ecc"] = seg_launches["segment_ecc"]
    by_lib = {"arena_bitflip": "arena_bitflip", "arena_ecc": "arena_ecc",
              "faulty_decode_attention": "faulty_decode",
              "paged_decode_attention": "paged_decode",
              "bitflip": "segment_bitflip", "segment_ecc": "segment_ecc",
              "flash_attention": "flash_prefill", "rglru_scan": "rglru_scan"}
    for row in rows:
        lib = by_lib[row["name"]]
        row["launches"] = counts[lib]
        by_variant = {key[len(lib) + 1:]: n for key, n in counts.items()
                      if key.startswith(lib + "/")}
        if by_variant:
            row["launches_by_variant"] = by_variant
        if row["launches"] <= 0:
            raise AssertionError(f"kernel {row['name']} was not launched on "
                                 "its main path")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernels": rows,
             "serving": phases, "token_agreement": agree,
             "scheduler": sched_phases, "scheduler_agreement": sched_agree,
             "sweep": sweep_row, "segments": seg_report,
             "governor": governor_row, "row_invariance": row_report,
             "hybrid_serving": hyb_phases,
             "hybrid_token_differ_from_nofault": hyb_differ,
             "hybrid_scheduler": hyb_sched_phases,
             "hybrid_small_logit_err": hyb_small_err,
             "sass_per_word": sass, "ops_per_word": ops_per_word,
             "total_s": time.perf_counter() - t_start},
            indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "host_ms", "variant", "launches_by_variant",
            "variants")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
