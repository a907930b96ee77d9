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
     0.975 V tokens), with the kernels' launch counts; every decode step
     after the first replays one captured CUDA graph, and the 0.88 V write
     and 0.8775 V ECC read requests served again with every step eager
     give the same tokens, K/V words and launches;
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
     write, unlike a 0.975 V run; K4 launched 28 times per step; the
     decode-only step captured once per scheduler (``decode_traces`` 1),
     and the 0.88 V write traffic served again with every step eager
     gives the same tokens, pool words and launches;
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
 12. full-width recurrentgemma-9b cut to 20 of its 38 layers (bf16,
     weights from a seeded generator, the llama weights freed first)
     through ``generate()``:
     batch 4, a 2560-token prompt (past the local window), 32 new tokens,
     the cache in the 16-PC domain: clean, 0.98 V (must equal clean),
     0.975 V (the no-fault reference), 0.91 V write, 0.88 V write and
     rewrite (must be equal) and 0.875 V ECC write; K7 launched 6 times
     per prefill, all through its wgmma variant, K8 14 times per prefill
     and per decode step, all through its gated entry, K1/K2 once per
     undervolted write request; the 0.88 V write and rewrite requests
     served again with every decode step eager give the same tokens,
     cache words (rings, h, conv tails) and launches;
 13. the same model through ``ContinuousBatchingScheduler``, which must
     give the state-arena scheduler: 3 slots, 6 requests (prompts
     128..1024, 8..24 new tokens), clean and 0.88 V write, each request
     == its solo ``generate()`` replay, K8 14 times per step and per
     admission (all gated), every K7 admission launch through the wgmma
     variant, the step captured once (``decode_traces`` 1) and equal on
     tokens, state words and launches to the same traffic served with
     every step eager.

 14. H1, self-healing in the reference test's regime: reduced llama3.2-3b
     in float32, the KV domain on VCU128 PCs 8, 15, 18 and 29 at 0.91 V
     with ECC, read mode, 4 slots, 16 pages of 8, three requests, a row
     under a live page weakened (``weaken_row``) after 2 steps: migrations
     and quarantined pages >= 1, nothing uncorrectable, decode_traces 1,
     each request == its solo replay on its final placement, captured ==
     eager (tokens, pool words, per-step telemetry, migration pairs,
     quarantine), K2's count-only entry == the plain scrub at the chaos
     step;
 15. H2, self-healing at full width: the scheduler cell's pool in the
     16-PC domain at 0.91 V with ECC, read, ``SelfHealConfig()``, the
     first 4 of the 8 requests, a row weakened after 2 decode-only steps:
     no request lost, each == its replay, decode_traces 1, K4 28 and the
     scrub (K2's count-only entry) 2 launches in every step, quarantine
     monotone, captured == eager; K2's count-only entry == plain over the
     whole pool at the chaos step and timed there beside its bound; the
     steady decode-only step with and without ``self_heal``, the host ms
     of the healing loop per step and its counters are printed (F4 makes
     every page weak: no gate on the migration count);
 16. the scheduler's per-admission governor at full width: the 8 requests
     under a rate governor (tolerable rate 1e-3, v_lo 0.87, bitwise,
     read): the voltage moves off 0.91 V, decode_traces 1 across the
     moves, captured == eager on tokens; the admitted voltages printed.

 17. T1, the quickstart on the card (``python -m
     repro_torch.examples.quickstart``: reduced llama3.2-3b, bf16,
     aggressive_plan(0.93 V, TPU_V5E), microbatches 2, seq 64, batch 8,
     60 steps): its own assertion (final loss < 5.0), one K1 launch per
     step; the same configuration in float32 for 5 steps on the card and
     on the CPU from one init, losses within 1e-4 relative; K1 at one
     step == its plain version on the same post-AdamW words (and at 0.86
     V word if 0.93 V changes no word of the reduced arena);
 18. T3 (reduced, the quickstart's configuration): save at step 5, then
     3 steps on; restore and the same 3 steps: equal losses and state
     bits (deterministic algorithms); then a governed run whose power
     budget moves every step: governor_voltage follows the governor, and
     every K1 call ran its step's voltage's thresholds and == plain;
 19. T4: reduced recurrentgemma-9b in float32: forward_train and 5 steps
     on the card within 1e-4 relative of the CPU;
 20. T2, training at full width: llama3.2-3b cut to 8 layers (the
     deepest whose moments fit the plan: 9 must raise CapacityError), the
     moments on TPU_V5E's 25 most reliable PCs at V_MIN, the parameters
     on the other 7; global batch 8 x 1024, microbatches 2.  The cell:
     12 steps with ECC on the cheap domain at 0.94 V (one K2 launch per
     step, K2 == plain on words and counts at one step, corrected faults
     every step, training and held-out loss finite and falling), timed
     (ms per step, forward + backward, AdamW, injection, tokens/s, peak
     memory) and one step traced; 4 steps unprotected at 0.91 V word (one
     K1 launch per step, K1 == plain with words changed, K1 timed over
     the 0.8 G-word parameter arena beside its bound; losses reported);
     4 steps with every domain at V_MIN == 4 steps with no plan on bits.
     Every codeword K2 counts uncorrectable in a step of the cell is
     logged on a line of its own (block, base word, word id, PC, stored
     and output words: the operands of tests/test_torch_ecc_codewords.py)
     and the plain per-codeword path must flag exactly K2's counts.

 21. Y, the model zoo's head shapes at K3 and K4: gemma3-4b's window ring
     (1024 slots, window 1024) and global ring (2048), D 256, G 2;
     llama3-8b (G 4) and yi-34b (G 7), D 128: K4 == its plain version and
     == K3 over the same words (bits, injection on and off), K3 at
     generate()'s tile == plain, each timed beside its bound and SDPA.
     yi-34b runs only at this shape: its 34.4 B params take 68.8 GB in
     bf16, too little of the card for a cache and its float32 logits.
 22. G, gemma3-4b at full width (34 layers, 4.5 B params, bf16):
     generate() with batch 4, a 1536-token prompt past the 1024-token
     window (the local rings wrap), 32 new tokens, max_len 2048: clean,
     0.98 V (== clean), 0.91 V read == write, 0.88 V write, 0.875 V ECC
     read == write, K3 once per layer and decode step; the 0.88 V write
     request with every step eager == captured (tokens, cache words,
     launches); one captured decode step traced.  Then the paged
     scheduler (4 slots, pages of 8, chunks of 64, 6 requests of 96..1536
     tokens at 0.91 V read): chunked prefill over the window rings, each
     request == its solo generate(kv_placement=...) replay, decode_traces
     1, K4 once per layer and step, captured == eager; the exporters'
     JSON snapshot and Prometheus page of that scheduler.
 23. Y, llama3-8b at full width (32 layers, 8.0 B params): generate(),
     batch 4 x 512 tokens, clean and 0.88 V write (K3 once per layer and
     step).
 24. M, deepseek-v2-lite-16b at full width (27 layers: MLA with a 576-wide
     latent ring, 64 routed experts top 6 + 2 shared; 15.7 B params):
     generate() batch 4 x 512, clean and 0.88 V 'auto' (== write),
     captured == eager (tokens, latent cache words, launches), one
     captured decode step traced; the state-arena scheduler (3 slots, 6
     requests of 128..1024 tokens at 0.88 V write): each request == its
     solo replay, decode_traces 1, captured == eager.  Then expert
     criticality tiering at full width cut to 16 layers (the deepest
     whose experts place on aggressive_plan(0.88 V); 17 must not): tiers
     16 / 32 / 16, every K1 launch of the one-time expert injection ==
     plain on the same words, 4 requests each == its solo replay on
     ``sched.params``.
 25. The state families' small checks: reduced xlstm-350m,
     whisper-large-v3 and internvl2-2b in float32 give the same greedy
     tokens on the card as on the CPU (clean, 0.86 V write, 0.875 V ECC
     write; extras batched), and one train step's loss on the card is
     within 1e-5 (1 + |CPU|) of the CPU's (the loss after it within 1e-4).
 26. X, xlstm-350m at full width (24 layers: 12 mLSTM with 12.6 MB of
     matrix memory per row, 12 sLSTM; bf16): generate() batch 4, prompt
     1,024, 32 new, max_len 1,088: clean, 0.98 V (== clean), 0.88 V write,
     0.875 V ECC write; the 0.88 V write request served again with every
     step eager == captured (tokens, state words, launches); the
     state-arena scheduler (3 slots, 6 requests of 128..1,024 tokens at
     0.88 V write): each == its solo replay, decode_traces 1, captured ==
     eager (tokens, state words, launches).
 27. W, whisper-large-v3 at full width (32 + 32 layers, bf16): generate()
     batch 4 with seeded frames (4, 1,500, 1,280), prompt 64, 32 new,
     max_len 448 (the text context), the modes of X; the cross leaves'
     per-step re-injection timed beside the captured step; the state
     arena with 6 requests, three repeating one (tokens, frames) under
     share_prefix (prefill_reuse 2, equal tokens), the checks of X.
 28. V, internvl2-2b at full width (24 layers, 256 image tokens from
     seeded 1,024-wide patches, bf16): generate() batch 4 x 512 text
     tokens, 32 new, max_len 1,024, clean and 0.88 V write, captured ==
     eager; the state arena with 6 requests of 64..512 text tokens, the
     checks of X.
     In 26-28 every K1 / K2 launch == its plain version on the same words
     as it returns, and one captured decode step is traced.

Each of the four serving cells (llama generate(), the paged decode-only
step, recurrentgemma generate(), the state-arena step) is also traced
with torch.profiler, eager and captured (generate() clean and at 0.88 V
write, the schedulers at 0.88 V write): decode steps 3 and 4 of a short
run, each followed by a device sync, give the device-idle share of the
traced steps' window (busy and wall time from the same steps), the host
us per device op and the top ops by device time; the unprofiled steps'
wall time is printed beside it.

Phases 6-8 run after the K4 phase, 9 after the generate() phases, 10
and 11 after 8, 14 after 2, 15 and 16 after 5, 17-19 after 11, 20 after
16 (the llama serving weights freed first), 12 and 13 after 20, 21-28
last, each model's weights freed before the next is made.  The phases'
seconds are printed (``phase seconds``).  ``--phases base,T2,zoo``
runs groups of them alone (base: 1-19, T2: 20, zoo: 21-28), and
``--phases X,W,V`` the state families alone (25 with the ones named),
without the kernels line.  The kernel rows' launches of K1 and K2 add
those of T1's quickstart and T2's two legs.
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
import os
import statistics
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
# Its depth, cut from 38 to 20 layers (14 recurrent, 6 local attention)
# to make room in the script's time for the state families (X, W, V):
# the cell's prefills of 2,560 tokens took 7-8 s each at 38 layers.
HYB_LAYERS = 20
HYB_SLOTS, HYB_SCHED_MAX_LEN = 3, 2048
HYB_SCHED_PROMPTS = (128, 1024, 384, 640, 256, 896)
HYB_SCHED_NEW = (8, 24, 16, 12, 20, 10)
# The traced recurrentgemma runs prefill this many tokens (the decode step
# has the cell's shape whatever the prompt).
HYB_TRACE_PROMPT = 256


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


def tree_bits_equal(a, b) -> bool:
    """Every leaf of two trees equal on bits (the cache words of two runs)."""
    from repro_torch.core import pytree
    la, lb = pytree.leaves(a), pytree.leaves(b)
    return len(la) == len(lb) and all(bits_equal(x, y) for x, y in zip(la, lb))


def recording(bundle):
    """``bundle`` with a module that keeps the cache its decode steps
    write, so a generate() run's final K/V and state words can be read."""
    seen = {}

    class _Module:
        def __getattr__(self, name):
            return getattr(bundle.module, name)

        def decode_step(self, params, cache, *args, **kwargs):
            seen["cache"] = cache
            return bundle.module.decode_step(params, cache, *args, **kwargs)

    return dataclasses.replace(bundle, module=_Module()), seen


def steady_ms(step_seconds) -> float:
    """Median ms of the decode steps after the first two (the eager
    warm-up and the step that captures the graph)."""
    import numpy as np
    rest = list(step_seconds)[2:] or list(step_seconds)
    return 1e3 * float(np.median(rest))


# Decode steps traced by trace_decode_steps: the profiler waits through
# steps 0 and 1 (warm-up, capture), warms up on 2 and records 3 and 4;
# steps 5 and later run unprofiled and give the step's own wall time.
TRACE_NEW = 10
TRACE_DIR = ROOT / "build" / "traces"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_metrics(path, step_name: str = "decode_step",
                   n_top: int = 5) -> dict:
    """Device-busy share of each traced step's window (from the step's
    host start to the end of its last device op; the union of the device
    intervals over that wall time), host us per device op (the step's
    host span over the ops it launched) and the ``n_top`` ops by device
    time, from a chrome trace of torch.profiler whose steps are
    ``step_name`` ranges."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    steps = sorted((float(e["ts"]), float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("name") == step_name
                   and e.get("cat") == "user_annotation")
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS)
    window = busy = host = 0.0
    n_ops, by_name = 0, {}
    for i, (t0, dur) in enumerate(steps):
        t_next = steps[i + 1][0] if i + 1 < len(steps) else float("inf")
        inside = [o for o in ops if t0 <= o[0] < t_next]
        t1 = max([t0 + dur] + [o[1] for o in inside])
        window += t1 - t0
        host += dur
        n_ops += len(inside)
        end = t0
        for a, b, name in inside:          # sorted by start: merge
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
            by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return dict(steps=len(steps), window_ms=window / 1e3 / max(len(steps), 1),
                busy_ms=busy / 1e3 / max(len(steps), 1),
                idle_share=(1.0 - busy / window) if n_ops else None,
                device_ops_per_step=n_ops / max(len(steps), 1),
                host_us_per_op=(host / n_ops) if n_ops else None,
                top_ms_per_step=[(n[:60], t / 1e3 / max(len(steps), 1))
                                 for n, t in top])


def trace_decode_steps(label: str, run) -> dict:
    """``run()`` (a serving call) under torch.profiler: every decode step
    (each CapturedStep call) is a ``decode_step`` range followed by a
    device sync, and steps 3 and 4 are recorded.  Returns
    :func:`_trace_metrics` (``idle_share`` None: the trace held no device
    op), whose busy time and window come from the same traced steps, plus
    ``step_ms``, the median wall time of the unprofiled steps from 5 on,
    reported beside it and not mixed into the share: the profiler adds
    host and device time to every traced op, so the traced window is
    longer than an unprofiled step.  An idle share outside [0, 1] fails
    the run (a measurement that does not hold together)."""
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    from repro_torch.serving import captured
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{label}.json"
    if path.exists():
        path.unlink()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=2, warmup=1, active=2, repeat=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(str(path)))
    orig = captured.CapturedStep.__call__
    walls = []

    def traced(self):
        t0 = time.perf_counter()
        with record_function("decode_step"):
            out = orig(self)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        prof.step()
        return out

    captured.CapturedStep.__call__ = traced
    try:
        with prof:
            run()
    finally:
        captured.CapturedStep.__call__ = orig
    if not path.exists():
        raise AssertionError(f"trace[{label}]: fewer than 5 decode steps")
    m = _trace_metrics(path)
    path.unlink()
    if len(walls) < 7:
        raise AssertionError(f"trace[{label}]: {len(walls)} decode steps, "
                             "fewer than 7")
    m["step_ms"] = 1e3 * float(statistics.median(walls[5:]))
    if m["idle_share"] is None:
        log(f"trace[{label}]: no device op in the profiler's trace")
    elif not 0.0 <= m["idle_share"] <= 1.0:
        raise AssertionError(f"trace[{label}]: idle share "
                             f"{m['idle_share']} outside [0, 1]")
    else:
        log(f"trace[{label}]: {m['window_ms']:.3f} ms per traced step "
            f"window, device busy {m['busy_ms']:.3f} ms, idle share "
            f"{m['idle_share']:.3f} of the traced window (unprofiled step "
            f"{m['step_ms']:.3f} ms), "
            f"{m['device_ops_per_step']:.0f} device "
            f"ops per step, host {m['host_us_per_op']:.2f} us per op; top "
            f"by device ms per step: {m['top_ms_per_step']}")
    return m


def trace_pair(label: str, make_run) -> dict:
    """The eager and the captured decode step of one cell, traced:
    ``make_run(capture)`` returns the serving call."""
    return {mode: trace_decode_steps(f"{label}_{mode}",
                                     make_run(mode == "captured"))
            for mode in ("eager", "captured")}


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
    # every row decodes position L + 5: ring slot 5 is the one written
    # this step (K3 reads the (B,) positions on the device)
    clean = 5
    q_pos = torch.full((B,), L + clean, dtype=torch.int32, device=dev)

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
                     ecc=c.ecc, inject=c.inject)

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
                pos[b:b + 1], q_pos=q_pos[b:b + 1],
                k_tables=(e.k.base, e.k.thr),
                v_tables=(e.v.base, e.v.thr), k_word0=word0,
                v_word0=layer * e.v.layer_words + b * L * wps, seed=c.seed,
                method=c.method, words_per_row_log2=c.words_per_row_log2,
                ecc=c.ecc, inject=c.inject)
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
                q[s_:s_ + 1], rk, rv, rp, q_pos=q_pos[s_:s_ + 1],
                k_tables=kt, v_tables=vt, k_word0=0, v_word0=0,
                seed=fmap.seed, method=method,
                words_per_row_log2=fmap.words_per_row_log2, ecc=ecc,
                inject=inject, bkv=PS,
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

    def serve(label, plan, mode="auto", clean_traffic=False, capture=True):
        """Serve the traffic; undervolted pools take every request at the
        cheap tier without prefix sharing (see the critical check)."""
        sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=16, undervolt=plan,
                         kv_injection=mode, prefill_chunk=CHUNK,
                         share_prefix=clean_traffic)
        sched = ContinuousBatchingScheduler(
            bundle, cfg, params, sc, num_slots=SLOTS, num_pages=SCHED_PAGES,
            page_slots=PAGE_SLOTS, device=dev, capture=capture)
        for rid, toks, n, tier in reqs:
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                                 tier=tier if clean_traffic else "cheap"))
        before = _build.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sched.run()
        wall = time.perf_counter() - t0
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        k4 = launches["paged_decode"]
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
        if st["decode_traces"] != (int(len(dec) > 1) if capture
                                   else int(bool(dec))):
            raise AssertionError(f"sched[{label}]: decode_traces "
                                 f"{st['decode_traces']}, not one captured "
                                 "decode step")
        row = dict(steps=sched.steps, decode_steps=len(dec),
                   mixed_steps=len(mixed), captured=capture,
                   decode_traces=st["decode_traces"],
                   decode_step_steady_ms=steady_ms(dec),
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
        log(f"sched[{label}] mode={row['mode']}"
            f"{'' if capture else ' (eager)'}: {sched.steps} steps "
            f"({len(mixed)} mixed at {row['mixed_step_ms']:.1f} ms, "
            f"{len(dec)} decode-only at {row['decode_step_ms']:.1f} ms, "
            f"steady {row['decode_step_steady_ms']:.3f} ms), decode_traces "
            f"{st['decode_traces']}, "
            f"{n_tok / wall:.1f} tokens/s, peak active {sched.peak_active}, "
            f"TTFT {row['ttft_steps_mean']:.2f} steps (max "
            f"{row['ttft_steps_max']}), shared pages "
            f"{row['pages_shared']}, K4 {k4} launches = "
            f"{cfg.n_layers} x {sched.steps} steps")
        row["launches"] = launches
        return sc, res, toks, row, sched

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
    sc, res, toks["clean"], phases["clean"], _ = serve("clean", None,
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
        sc, res, toks[key], phases[key], sched = serve(label, plan_at(v, ecc),
                                                       mode)
        if key == "dense_write":
            kept = sched
        replay(label, sc, res)
        del sched
    _, _, toks["nofault"], phases["nofault"], _ = serve(
        f"{V_NO_FAULT}V read (no fault)", plan_at(V_NO_FAULT), "read")
    k4_total = _build.launch_counts()["paged_decode"]   # ... and ends here
    # Captured == eager: the dense write traffic with every step eager.
    _, _, etoks, eager, esched = serve(f"{V_DENSE}V write", plan_at(V_DENSE),
                                       "write", capture=False)
    cap = phases["dense_write"]
    if any(not np.array_equal(etoks[r], toks["dense_write"][r])
           for r in etoks):
        raise AssertionError("sched dense write: captured tokens != eager")
    if not tree_bits_equal(kept.state["pool"], esched.state["pool"]):
        raise AssertionError("sched dense write: captured pool words != "
                             "eager")
    if cap["launches"] != eager["launches"] or kept.steps != esched.steps:
        raise AssertionError(f"sched dense write: captured launches "
                             f"{cap['launches']} != eager "
                             f"{eager['launches']}")
    del kept, esched
    phases["dense_write_eager"] = eager
    phases["captured_vs_eager"] = dict(
        eager_step_ms=eager["decode_step_steady_ms"],
        captured_step_ms=cap["decode_step_steady_ms"])
    log(f"sched[{V_DENSE}V write]: captured == eager on every request's "
        f"tokens and the pool's words, the same launches (K4 "
        f"{cap['k4_per_step']:.0f} per step); decode-only step {cap['decode_step_steady_ms']:.3f} ms "
        f"captured vs {eager['decode_step_steady_ms']:.3f} eager")

    def traced_traffic(capture):
        sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=TRACE_NEW,
                         undervolt=plan_at(V_DENSE), kv_injection="write",
                         prefill_chunk=CHUNK)
        sched = ContinuousBatchingScheduler(
            bundle, cfg, params, sc, num_slots=SLOTS, num_pages=SCHED_PAGES,
            page_slots=PAGE_SLOTS, device=dev, capture=capture)
        for rid, toks_, *_ in reqs[:SLOTS]:
            sched.submit(Request(rid=rid, tokens=toks_[:CHUNK]))
        return sched.run

    phases["traces"] = trace_pair("paged_decode_step", traced_traffic)
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


# ---- self-healing (H1, H2) and the scheduler's admission governor -------
# The reference's self-healing regime (tests/test_selfhealing.py): a KV
# domain on the four least reliable VCU128 PCs at 0.91 V with ECC, where
# weak rows throw correctable SECDED events; 4 slots, 16 pages of 8,
# max_len 32, its three requests, and a row under a live page turning weak
# after two steps.
HEAL_PCS = (8, 15, 18, 29)
HEAL_WEAKEN_AFTER = 2
# H2 serves the scheduler cell's first four requests: all are admitted
# before anything is quarantined (at full width every page is weak, F4).
HEAL_REQS = 4
# The scheduler's per-admission governor, as the reference's test sets it.
SCHED_GOV_RATE, SCHED_GOV_V_LO = 1e-3, 0.87


def heal_drive(sched, weaken_after=HEAL_WEAKEN_AFTER, decode_only=False,
               keep_at_chaos=False):
    """Admit and step until drained.  After ``weaken_after`` steps (decode-
    only steps if ``decode_only``) the first row of the first live page
    turns weak (``weaken_row``).  Per step: the kernels' launches, the
    telemetry counters, the quarantine set and the migrations.  With
    ``keep_at_chaos`` the pool words and page table right after the first
    step under chaos are kept (copies) for the scrub check."""
    from repro_torch.kernels import _build
    hit, steps, kept = None, [], None
    while sched.queue or sched.n_active:
        sched.admit_pending()
        if not sched.n_active:
            break
        done = (len(sched.step_seconds["decode"]) if decode_only
                else sched.steps)
        if sched.heal is not None and hit is None and done >= weaken_after:
            pc, row = sched.pool.page_rows(sorted(sched.pool._owned)[0])[0]
            hit = (pc, row, sched.weaken_row(0, pc, row))
        before = _build.launch_counts()
        sched.step_once()
        after = _build.launch_counts()
        steps.append(dict(
            launches={k: after[k] - before[k] for k in after},
            telem=(sched.telemetry if sched.heal is not None else None),
            quarantined=set(sched.pool.quarantined_pages),
            migrations=sched.migrations))
        if keep_at_chaos and hit is not None and kept is None:
            kept = scrub_operands(sched)
    return hit, steps, kept


def scrub_operands(sched):
    """Copies of a scheduler's K/V pool leaves as (n_layers, total_pages,
    page_words) int32 words, with their static page tables and the page
    table's referenced mask: K2's count-only entry's operands at this step."""
    import torch
    p, kvc = sched.pool, sched.kvc
    ref = torch.zeros(p.total_pages, dtype=torch.bool, device=kvc.device)
    ref.index_fill_(0, sched.state["ptab"].reshape(-1).long(), True)
    ref[p.scratch_id] = False
    leaves = []
    for leaf in p.leaves:
        if leaf.which not in ("k", "v"):
            continue
        e = getattr(sched._tables.ctx[leaf.slot_key], leaf.which)
        words = kvc._leaf_arrays(sched.state["pool"], leaf).reshape(
            leaf.n_layers, p.total_pages, -1).view(torch.int32)
        leaves.append((words.clone(), e.base.clone(), e.thr.clone()))
    kw = dict(seed=p.faultmap.seed,
              words_per_row_log2=p.faultmap.words_per_row_log2)
    return dict(leaves=leaves, ref=ref, kw=kw)


def scrub_check(label, ops):
    """K2's count-only entry == its plain version, leaf by leaf, on the
    kept operands; returns the per-page (corrected, uncorrectable) sums."""
    import torch
    from repro_torch.kernels.ecc import ecc as ecc_mod
    tot = None
    for words, base, thr in ops["leaves"]:
        got = ecc_mod.ecc_page_events(words, base, thr, ops["ref"],
                                      **ops["kw"])
        want = ecc_mod.ecc_page_events_ref(words, base, thr, ops["ref"],
                                           **ops["kw"])
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise AssertionError(f"{label}: K2 count-only != its plain "
                                 "version on the pool's words")
        tot = got if tot is None else (tot[0] + got[0], tot[1] + got[1])
    return tot


def heal_equal(label, a, sa, b, sb):
    """Two runs of the same traffic (captured and eager) agree on tokens,
    pool words, per-step telemetry, migration pairs and quarantine."""
    import numpy as np
    if len(sa) != len(sb) or a.steps != b.steps:
        raise AssertionError(f"{label}: {a.steps} captured steps, "
                             f"{b.steps} eager")
    for i, (x, y) in enumerate(zip(sa, sb)):
        if not np.array_equal(x["telem"], y["telem"]):
            raise AssertionError(f"{label}: step {i} telemetry differs")
        if x["quarantined"] != y["quarantined"]:
            raise AssertionError(f"{label}: step {i} quarantine differs")
    mig = [[(e.step, e.data["src"], e.data["dst"])
            for e in s.trace.events("migration")] for s in (a, b)]
    if mig[0] != mig[1]:
        raise AssertionError(f"{label}: migration pairs differ")
    for rid in a.results:
        if not np.array_equal(a.results[rid].tokens, b.results[rid].tokens):
            raise AssertionError(f"{label}: request {rid} tokens differ")
    if not tree_bits_equal(a.state["pool"], b.state["pool"]):
        raise AssertionError(f"{label}: pool words differ")
    return len(mig[0])


def heal_replays(label, sched, reqs, bundle, cfg, params, dev):
    """Each request == its solo generate() on its final placement."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import generate
    for rid, toks, n, _ in reqs:
        ref = generate(bundle, cfg, params,
                       {"tokens": torch.from_numpy(np.asarray(toks))[None]},
                       dataclasses.replace(sched.sc, max_new_tokens=n),
                       device=dev, kv_placement=sched.results[rid].placement)
        if not np.array_equal(ref.cpu().numpy(), sched.results[rid].tokens):
            raise AssertionError(f"{label} request {rid}: tokens != its solo "
                                 "replay on its final placement")


def heal_reduced_phase(dev):
    """H1: the reference's self-healing test regime on the card (reduced
    llama3.2-3b, float32): migration and quarantine happen, nothing is
    uncorrectable, one decode trace, every request == its replay, captured
    == eager, and K2's count-only entry == the plain scrub at the chaos
    step."""
    import numpy as np
    import torch
    from repro_torch.core import pytree
    from repro_torch.core.domains import MemoryDomain
    from repro_torch.core.hbm import VCU128
    from repro_torch.models.base import get_arch, init_params
    from repro_torch.serving.engine import ServeConfig
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request, SelfHealConfig)
    from repro_torch.training.undervolt import UndervoltPlan
    t0 = time.perf_counter()
    bundle = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(bundle.reduced, dtype=torch.float32)
    params = pytree.tree_map(lambda t: t.to(dev), init_params(
        bundle.module.param_specs(cfg), torch.Generator().manual_seed(0),
        device="cpu"))
    rng = np.random.RandomState(7)
    reqs = [(rid, rng.randint(0, cfg.vocab, (n,)), m, tier)
            for rid, n, m, tier in (("a", 5, 8, "cheap"),
                                    ("b", 9, 10, "critical"),
                                    ("c", 12, 12, "cheap"))]
    plan = UndervoltPlan(
        domains={"kv": MemoryDomain("kv", V_FAULTY, HEAL_PCS, ecc=True)},
        policy={"kv_cache": "kv"}, geometry=VCU128)
    sc = ServeConfig(max_len=32, max_new_tokens=8, undervolt=plan,
                     kv_injection="read", kv_method="word")
    runs = []
    for capture in (True, False):
        sched = ContinuousBatchingScheduler(
            bundle, cfg, params, sc, num_slots=4, num_pages=16,
            page_slots=8, device=dev, self_heal=SelfHealConfig(),
            capture=capture)
        for rid, toks, n, tier in reqs:
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                                 tier=tier))
        hit, steps, kept = heal_drive(sched, keep_at_chaos=capture)
        runs.append((sched, steps, hit, kept))
    (a, sa, hit, kept), (b, sb, _, _) = runs
    st = a.stats
    if len(a.results) != len(reqs):
        raise AssertionError(f"H1: {len(a.results)} of {len(reqs)} served")
    if st["decode_traces"] != 1:
        raise AssertionError(f"H1: decode_traces {st['decode_traces']}")
    if not (st["migrations"] >= 1 and st["quarantined_pages"] >= 1
            and st["uncorrectable"] == 0):
        raise AssertionError(f"H1: migrations {st['migrations']}, "
                             f"quarantined {st['quarantined_pages']}, "
                             f"uncorrectable {st['uncorrectable']}")
    heal_replays("H1", a, reqs, bundle, cfg, params, dev)
    pairs = heal_equal("H1", a, sa, b, sb)
    corr, bad = scrub_check("H1 chaos step", kept)
    sh = st["shards"][0]
    seconds = time.perf_counter() - t0
    log(f"H1 self-healing, reduced llama3.2-3b f32, PCs {HEAL_PCS} at "
        f"{V_FAULTY} V ECC read: row {hit[:2]} weakened after "
        f"{HEAL_WEAKEN_AFTER} steps ({len(hit[2])} pages); {a.steps} steps, "
        f"{sh['migrations']} migrations ({pairs} pairs, captured == eager), "
        f"{sh['migration_stalls']} stalls, {sh['quarantined_pages']} pages "
        f"quarantined, {sh['corrected']} corrected, {sh['uncorrectable']} "
        f"uncorrectable, {sh['tracked_rows']} rows tracked, "
        f"{sh['suspect_rows']} suspect; decode_traces 1; every request == "
        f"its replay on its final placement; K2 count-only == plain at the "
        f"chaos step ({int(corr.sum())} corrected); {seconds:.1f} s")
    return dict(steps=a.steps, hit=[int(hit[0]), int(hit[1])],
                seconds=seconds, **{k: sh[k] for k in (
                    "migrations", "migration_stalls", "quarantined_pages",
                    "quarantined_blocks", "corrected", "uncorrectable",
                    "tracked_rows", "suspect_rows")})


def heal_full_width_phase(dev, bundle, cfg, params, ops_per_word):
    """H2: self-healing at full width on the scheduler cell's pool, with
    K2's count-only entry timed at the shapes of that path.  Returns the
    phase's report, the kernel row and the path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ecc import ecc as ecc_mod
    from repro_torch.serving.engine import ServeConfig
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request, SelfHealConfig)
    t0 = time.perf_counter()
    reqs = [(rid, toks, n, "cheap")
            for rid, toks, n, _ in scheduler_traffic(cfg.vocab)[:HEAL_REQS]]
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=16,
                     undervolt=plan_at(V_FAULTY, True), kv_injection="read",
                     prefill_chunk=CHUNK)

    def serve(heal, capture):
        sched = ContinuousBatchingScheduler(
            bundle, cfg, params, sc, num_slots=SLOTS, num_pages=SCHED_PAGES,
            page_slots=PAGE_SLOTS, device=dev, capture=capture,
            self_heal=SelfHealConfig() if heal else None)
        for rid, toks, n, tier in reqs:
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                                 tier=tier))
        return sched

    _build.reset_launch_counts()        # the healing path starts here
    a = serve(True, True)
    hit, sa, kept = heal_drive(a, decode_only=True, keep_at_chaos=True)
    launches = _build.launch_counts()   # ... and ends here
    st = a.stats
    if sorted(a.results) != sorted(r for r, *_ in reqs):
        raise AssertionError(f"H2: served {sorted(a.results)}")
    if st["decode_traces"] != 1:
        raise AssertionError(f"H2: decode_traces {st['decode_traces']}")
    for i, step in enumerate(sa):
        k4 = step["launches"]["paged_decode"]
        scrub = step["launches"]["arena_ecc_events"]
        if k4 != cfg.n_layers or scrub != 2:
            raise AssertionError(f"H2 step {i}: K4 {k4}, scrub {scrub} "
                                 f"launches (want {cfg.n_layers}, 2)")
        if i and not step["quarantined"] >= sa[i - 1]["quarantined"]:
            raise AssertionError(f"H2 step {i}: quarantine shrank")
    heal_replays("H2", a, reqs, bundle, cfg, params, dev)
    b = serve(True, False)
    _, sb, _ = heal_drive(b, decode_only=True)
    pairs = heal_equal("H2", a, sa, b, sb)
    del b
    plain = serve(False, True)
    heal_drive(plain, decode_only=True)
    corr, bad = scrub_check("H2", kept)

    # K2's count-only entry at this path's shapes: one step's scrub (one
    # launch per K/V leaf) over the pool and page table of the chaos step
    ref = kept["ref"]
    n_ref = int(ref.sum())

    def scrub():
        for words, base, thr in kept["leaves"]:
            ecc_mod.ecc_page_events(words, base, thr, ref, **kept["kw"])

    def scrub_plain():
        for words, base, thr in kept["leaves"]:
            ecc_mod.ecc_page_events_ref(words, base, thr, ref, **kept["kw"])

    ms = cuda_ms(scrub, reps=10, queue_s=QUEUE_S)
    host_ms = cuda_ms(scrub, reps=10)
    plain_ms = cuda_ms(scrub_plain, reps=1, warmup=0)
    words = sum(n_ref * w.shape[0] * w.shape[2] for w, _, _ in kept["leaves"])
    table_bytes = sum(n_ref * w.shape[0] * 4 * 12
                      for w, _, _ in kept["leaves"])
    b_ms, b_by = bound(4 * words + table_bytes + ref.numel() * (1 + 16),
                       int_ops=words * ops_per_word["ecc"])
    steady_heal = steady_ms(a.step_seconds["decode"])
    steady_plain = steady_ms(plain.step_seconds["decode"])
    heal_host = 1e3 * np.asarray(a.heal_seconds)
    sh = st["shards"][0]
    seconds = time.perf_counter() - t0
    report = dict(
        steps=a.steps, decode_steps=len(a.step_seconds["decode"]),
        hit=[int(hit[0]), int(hit[1])], weakened_pages=len(hit[2]),
        migration_pairs=pairs, decode_step_steady_ms=steady_heal,
        decode_step_steady_ms_no_heal=steady_plain,
        heal_host_ms_median=float(np.median(heal_host)),
        heal_host_ms_max=float(heal_host.max()),
        scrub_ms=ms, scrub_bound_ms=b_ms, scrub_bound_by=b_by,
        scrub_corrected_at_chaos=int(corr.sum()),
        referenced_pages=n_ref, seconds=seconds,
        **{k: sh[k] for k in ("migrations", "migration_stalls",
                              "quarantined_pages", "quarantined_blocks",
                              "corrected", "uncorrectable", "tracked_rows",
                              "suspect_rows", "free_pages")})
    log(f"H2 self-healing at full width ({HEAL_REQS} requests, {SCHED_PAGES}"
        f" pages, 16-PC domain at {V_FAULTY} V ECC read): row {hit[:2]} "
        f"weakened after {HEAL_WEAKEN_AFTER} decode-only steps "
        f"({len(hit[2])} pages); {a.steps} steps, K4 {cfg.n_layers} and "
        f"scrub 2 launches in every step; decode_traces 1; every request == "
        f"its replay; captured == eager (tokens, pool words, telemetry, "
        f"{pairs} migration pairs, quarantine); {sh['migrations']} "
        f"migrations, {sh['migration_stalls']} stalls, "
        f"{sh['tracked_rows']} rows tracked, {sh['suspect_rows']} suspect, "
        f"{sh['quarantined_pages']} pages / {sh['quarantined_blocks']} "
        f"blocks quarantined, {sh['corrected']} corrected, "
        f"{sh['uncorrectable']} uncorrectable, {sh['free_pages']} pages "
        f"free; steady captured decode-only step {steady_heal:.3f} ms with "
        f"self_heal, {steady_plain:.3f} ms without; healing host half "
        f"{report['heal_host_ms_median']:.2f} ms per step (median, max "
        f"{report['heal_host_ms_max']:.2f}); K2 count-only {ms:.4f} ms per "
        f"step on the device ({host_ms:.4f} at the host pace) over "
        f"{n_ref} referenced pages, bound {b_ms:.4f} ms by {b_by}, plain "
        f"{plain_ms:.2f} ms, == plain at the chaos step; {seconds:.1f} s")
    row = dict(name="ecc_page_events", route="cuda",
               source="src/repro_torch/kernels/csrc/arena_ecc.cu",
               replaces="src/repro/kernels/ecc/ecc.py:105",
               max_abs_err=0.0, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               referenced_pages=n_ref, voltage=V_FAULTY)
    torch.cuda.empty_cache()
    return report, row, launches


def sched_governor_phase(dev, bundle, cfg, params):
    """The scheduler's per-admission governor at full width: the voltage
    moves off 0.91 V across admissions, the decode-only step is captured
    once across those moves, and captured == eager on tokens."""
    import numpy as np
    from repro_torch.serving.engine import ServeConfig
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request)
    t0 = time.perf_counter()
    reqs = scheduler_traffic(cfg.vocab)
    runs, volts = [], []
    for capture in (True, False):
        plan = plan_at(V_FAULTY)
        gov = plan.make_governor("kv", mode="rate",
                                 tolerable_rate=SCHED_GOV_RATE,
                                 v_lo=SCHED_GOV_V_LO)
        sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=16, undervolt=plan,
                         governor=gov, kv_injection="read",
                         kv_method="bitwise", prefill_chunk=CHUNK)
        sched = ContinuousBatchingScheduler(
            bundle, cfg, params, sc, num_slots=SLOTS, num_pages=SCHED_PAGES,
            page_slots=PAGE_SLOTS, device=dev, capture=capture)
        voltages = [sched.voltage]          # the domain's configured one
        for rid, toks, n, _ in reqs:
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
        while sched.queue or sched.n_active:
            sched.admit_pending()
            voltages.append(sched.voltage)
            sched.step_once()
        runs.append(sched)
        volts.append(voltages)
    a, b = runs
    admitted = {rid: a.results[rid].voltage for rid, *_ in reqs}
    if all(abs(v - V_FAULTY) < 1e-9 for v in admitted.values()):
        raise AssertionError(f"sched governor: every admission at {V_FAULTY}"
                             " V")
    if a.stats["decode_traces"] != 1:
        raise AssertionError(f"sched governor: decode_traces "
                             f"{a.stats['decode_traces']}")
    for rid, *_ in reqs:
        if not np.array_equal(a.results[rid].tokens, b.results[rid].tokens):
            raise AssertionError(f"sched governor {rid}: captured tokens != "
                                 "eager")
        if a.results[rid].voltage != b.results[rid].voltage:
            raise AssertionError(f"sched governor {rid}: admitted voltages "
                                 "differ")
    moves = sum(1 for x, y in zip(volts[0], volts[0][1:]) if x != y)
    seconds = time.perf_counter() - t0
    log(f"sched governor (rate {SCHED_GOV_RATE}, v_lo {SCHED_GOV_V_LO}, "
        f"bitwise read, 8 requests): admitted voltages "
        f"{[admitted[r] for r, *_ in reqs]}; the pool voltage moved "
        f"{moves} times over {a.steps} steps with decode_traces 1; captured "
        f"== eager on every request's tokens; {seconds:.1f} s")
    return dict(admitted=admitted, voltage_moves=moves, steps=a.steps,
                decode_traces=a.stats["decode_traces"], seconds=seconds)


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

    def run(label, plan, mode="auto", capture=True, keep_cache=False):
        sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW, undervolt=plan,
                         kv_injection=mode)
        before = _build.launch_counts()
        timings = {}
        rec, seen = recording(bundle)
        toks = generate(rec, cfg, params, {"tokens": prompts}, sc,
                        device=dev, timings=timings, capture=capture)
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        if toks.shape != (B, NEW) or int(toks.min()) < 0 or int(
                toks.max()) >= cfg.vocab:
            raise AssertionError(f"{label}: bad token tensor {toks.shape}")
        dec_tok = timings["decode"] / (NEW - 1)
        steps = timings.pop("steps")
        steady = steady_ms(steps)
        log(f"serve[{label}] mode={timings['mode']}"
            f"{'' if capture else ' (eager)'}: prefill "
            f"{timings['prefill'] * 1e3:.1f} ms, inject "
            f"{timings['inject'] * 1e3:.2f} ms, decode "
            f"{dec_tok * 1e3:.2f} ms/token over the loop (steady "
            f"{steady:.3f}; step 0 {steps[0] * 1e3:.1f}, step 1 "
            f"{steps[1] * 1e3:.1f}), {B * (NEW - 1) / timings['decode']:.1f} "
            f"tokens/s (batch {B}), launches {launches}")
        return toks.cpu(), dict(timings, launches=launches, captured=capture,
                                decode_ms_per_token=dec_tok * 1e3,
                                steady_ms_per_token=steady,
                                first_steps_ms=[1e3 * t for t in steps[:2]],
                                tokens_per_s=B * (NEW - 1) / timings["decode"],
                                cache=seen["cache"] if keep_cache else None)

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
        toks[key], phases[key] = run(label, plan, mode, keep_cache=key in (
            "dense_write", "mid_ecc_read"))
    counts = _build.launch_counts()        # ... and ends here
    # Captured == eager: the same requests with every decode step eager.
    captured_vs_eager = {}
    for key, plan, mode in (("dense_write", plan_at(V_DENSE), "write"),
                            ("mid_ecc_read", plan_at(V_MID_ECC, True),
                             "read")):
        etoks, eager = run(f"{key} eager", plan, mode, capture=False,
                           keep_cache=True)
        cap = phases[key]
        if not torch.equal(etoks, toks[key]):
            raise AssertionError(f"{key}: captured tokens != eager")
        if not tree_bits_equal(cap.pop("cache"), eager.pop("cache")):
            raise AssertionError(f"{key}: captured K/V words != eager")
        if cap["launches"] != eager["launches"]:
            raise AssertionError(f"{key}: captured launches "
                                 f"{cap['launches']} != eager "
                                 f"{eager['launches']}")
        captured_vs_eager[key] = dict(
            eager_ms_per_token=eager["steady_ms_per_token"],
            captured_ms_per_token=cap["steady_ms_per_token"],
            eager_loop_ms_per_token=eager["decode_ms_per_token"],
            captured_loop_ms_per_token=cap["decode_ms_per_token"])
        log(f"serve[{key}]: captured == eager on tokens and K/V words, "
            f"launches equal; steady decode {cap['steady_ms_per_token']:.3f} "
            f"ms/token captured vs {eager['steady_ms_per_token']:.3f} eager")
    torch.cuda.empty_cache()
    traces = {}
    for key, plan, mode in (("clean", None, "auto"),
                            ("dense_write", plan_at(V_DENSE), "write")):
        sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=TRACE_NEW,
                         undervolt=plan, kv_injection=mode)
        traces[key] = trace_pair(f"llama_generate_{key}", lambda c, sc=sc: (
            lambda: generate(bundle, cfg, params, {"tokens": prompts}, sc,
                             device=dev, capture=c)))
    phases["captured_vs_eager"] = captured_vs_eager
    phases["traces"] = traces
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
    """recurrentgemma-9b at full width cut to HYB_LAYERS layers, bf16,
    weights from a seeded generator."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.models.base import get_arch, init_params
    bundle = get_arch("recurrentgemma-9b")
    cfg = dataclasses.replace(bundle.cfg, n_layers=HYB_LAYERS)
    t0 = time.perf_counter()
    params = init_params(bundle.module.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.leaves(params))
    log(f"recurrentgemma-9b full width: {n_params / 1e9:.3f} B params "
        f"({cfg.n_layers} of {bundle.cfg.n_layers} layers, d_model {cfg.d_model}, lru {cfg.lru_width}, "
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

    def run(label, plan, mode="write", capture=True, keep_cache=False):
        sc = ServeConfig(max_len=HYB_MAX_LEN, max_new_tokens=HYB_NEW,
                         undervolt=plan, kv_injection=mode)
        before = _build.launch_counts()
        wgmma_before = _build.variant_counts("flash_prefill").get("wgmma", 0)
        gated_before = _build.variant_counts("rglru_scan").get("gated", 0)
        timings = {}
        rec, seen = recording(bundle)
        toks = generate(rec, cfg, params, {"tokens": prompts}, sc,
                        device=dev, timings=timings, capture=capture)
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
        steps = timings["steps"]
        steady = steady_ms(steps)
        log(f"hybrid serve[{label}] mode={timings['mode']}"
            f"{'' if capture else ' (eager)'}: prefill "
            f"{timings['prefill'] * 1e3:.1f} ms, inject "
            f"{timings['inject'] * 1e3:.2f} ms, decode {dec_tok * 1e3:.2f} "
            f"ms/token over the loop (steady {steady:.3f}; step 0 "
            f"{steps[0] * 1e3:.1f}, step 1 {steps[1] * 1e3:.1f}), "
            f"{HYB_B * (HYB_NEW - 1) / timings['decode']:.1f} "
            f"tokens/s (batch {HYB_B}), launches {launches}")
        return toks.cpu(), dict(
            prefill_ms=timings["prefill"] * 1e3,
            inject_ms=timings["inject"] * 1e3,
            decode_ms_per_token=dec_tok * 1e3, steady_ms_per_token=steady,
            first_steps_ms=[1e3 * t for t in steps[:2]], captured=capture,
            tokens_per_s=HYB_B * (HYB_NEW - 1) / timings["decode"],
            mode=timings["mode"], launches=launches,
            cache=seen["cache"] if keep_cache else None)

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
        toks[key], phases[key] = run(label, plan, mode, keep_cache=key in (
            "dense_write", "dense_rewrite"))
    counts = dict(_build.LAUNCHES)        # ... and ends here
    # Captured == eager: the write and rewrite requests with every decode
    # step eager.
    captured_vs_eager = {}
    for key, mode in (("dense_write", "write"), ("dense_rewrite", "rewrite")):
        etoks, eager = run(f"{V_DENSE}V {mode} eager", plan_at(V_DENSE),
                           mode, capture=False, keep_cache=True)
        cap = phases[key]
        if not torch.equal(etoks, toks[key]):
            raise AssertionError(f"hybrid {key}: captured tokens != eager")
        if not tree_bits_equal(cap.pop("cache"), eager.pop("cache")):
            raise AssertionError(f"hybrid {key}: captured cache words != "
                                 "eager")
        if cap["launches"] != eager["launches"]:
            raise AssertionError(f"hybrid {key}: captured launches "
                                 f"{cap['launches']} != eager "
                                 f"{eager['launches']}")
        captured_vs_eager[key] = dict(
            eager_ms_per_token=eager["steady_ms_per_token"],
            captured_ms_per_token=cap["steady_ms_per_token"],
            eager_loop_ms_per_token=eager["decode_ms_per_token"],
            captured_loop_ms_per_token=cap["decode_ms_per_token"])
        log(f"hybrid serve[{key}]: captured == eager on tokens and cache "
            f"words (K/V rings, h, conv tails), launches equal; steady "
            f"decode {cap['steady_ms_per_token']:.3f} ms/token captured vs "
            f"{eager['steady_ms_per_token']:.3f} eager")
        torch.cuda.empty_cache()
    traces = {}
    for key, plan in (("clean", None), ("dense_write", plan_at(V_DENSE))):
        sc = ServeConfig(max_len=HYB_MAX_LEN, max_new_tokens=TRACE_NEW,
                         undervolt=plan, kv_injection="write")
        traces[key] = trace_pair(f"hybrid_generate_{key}", lambda c, sc=sc: (
            lambda: generate(bundle, cfg, params,
                             {"tokens": prompts[:, :HYB_TRACE_PROMPT]}, sc,
                             device=dev, capture=c)))
    phases["captured_vs_eager"] = captured_vs_eager
    phases["traces"] = traces
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
    kept = {}
    for key, plan, capture in (
            ("clean", None, True), ("dense_write", plan_at(V_DENSE), True),
            ("dense_write_eager", plan_at(V_DENSE), False)):
        sc = ServeConfig(max_len=HYB_SCHED_MAX_LEN, max_new_tokens=8,
                         undervolt=plan, kv_injection="write")
        sched = ContinuousBatchingScheduler(bundle, cfg, params, sc,
                                            num_slots=HYB_SLOTS, device=dev,
                                            capture=capture)
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
        if capture:
            for name, n in _build.LAUNCHES.items():
                counts[name] = counts.get(name, 0) + n
        if sched.stats["decode_traces"] != 1:
            raise AssertionError(f"sched hybrid {key}: decode_traces "
                                 f"{sched.stats['decode_traces']}, not 1")
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
        for rid, toks, n in (reqs if capture else ()):
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
                           step_steady_ms=steady_ms(
                               sched.step_seconds["decode"]),
                           tokens=n_tok, tokens_per_s=n_tok / wall,
                           peak_active=sched.peak_active, captured=capture,
                           decode_traces=sched.stats["decode_traces"],
                           k8_per_step=n_rec, launches=launches)
        if key.startswith("dense_write"):
            kept[key] = ({rid: res[rid].tokens for rid, *_ in reqs},
                         sched.state["cache"])
        log(f"sched hybrid[{key}] (state arena, {HYB_SLOTS} slots, "
            f"{len(reqs)} requests): {sched.steps} steps at {step_ms:.1f} "
            f"ms (steady {phases[key]['step_steady_ms']:.3f}), decode_traces "
            f"{sched.stats['decode_traces']}, "
            f"{n_tok / wall:.1f} tokens/s (admission prefills "
            f"included), K8 {n_rec} (all gated) per step and per "
            f"admission, K7 "
            f"{launches['flash_prefill']} (all wgmma)"
            + ("" if not capture else
               "; every request == its solo generate("
               f"{'' if plan is None else 'kv_placement=...'}) replay"))
    (ctoks, ccache), (etoks, ecache) = (kept["dense_write"],
                                        kept.pop("dense_write_eager"))
    cap, eager = phases["dense_write"], phases["dense_write_eager"]
    if any(not np.array_equal(ctoks[r], etoks[r]) for r in ctoks):
        raise AssertionError("sched hybrid dense write: captured tokens != "
                             "eager")
    if not tree_bits_equal(ccache, ecache):
        raise AssertionError("sched hybrid dense write: captured state words "
                             "!= eager")
    if cap["launches"] != eager["launches"] or cap["steps"] != eager["steps"]:
        raise AssertionError(f"sched hybrid dense write: captured launches "
                             f"{cap['launches']} != eager "
                             f"{eager['launches']}")
    kept.clear()
    phases["captured_vs_eager"] = dict(
        eager_step_ms=eager["step_steady_ms"],
        captured_step_ms=cap["step_steady_ms"])
    log(f"sched hybrid[{V_DENSE}V write]: captured == eager on every "
        f"request's tokens and the state arena's words, the same launches; "
        f"step {cap['step_steady_ms']:.3f} ms captured vs "
        f"{eager['step_steady_ms']:.3f} eager")

    def traced_traffic(capture):
        sc = ServeConfig(max_len=HYB_SCHED_MAX_LEN, max_new_tokens=TRACE_NEW,
                         undervolt=plan_at(V_DENSE), kv_injection="write")
        sched = ContinuousBatchingScheduler(bundle, cfg, params, sc,
                                            num_slots=HYB_SLOTS, device=dev,
                                            capture=capture)
        for rid, toks, _ in reqs[:HYB_SLOTS]:
            sched.submit(Request(rid=rid, tokens=toks[:HYB_SCHED_PROMPTS[0]]))
        return sched.run

    phases["traces"] = trace_pair("state_arena_step", traced_traffic)
    torch.cuda.empty_cache()
    return counts, phases


# --------------------------------------------------------------- training
# T1: the quickstart (reduced llama3.2-3b, bf16, aggressive_plan(0.93 V,
# TPU_V5E), microbatches 2, seq 64, batch 8, 60 steps) and its float32
# twin on the card against the CPU.  T2: llama3.2-3b at full width cut to
# 8 layers -- the deepest whose float32 moments (11.87 GiB) fit the 25
# most reliable of TPU_V5E's 32 PCs of 512 MiB, the parameters (2.97 GiB)
# in the other 7 -- global batch 8 x 1024, microbatches 2.  T3:
# checkpoint continuation and governed training (reduced).  T4: reduced
# recurrentgemma-9b in float32, card against CPU.
T1_F32_STEPS = 5
T1_CHECK_STEP = 2
# A deeper cheap domain for T1's K1 check, if 0.93 V changes no word of
# the reduced arena.
T1_DEEP_V = 0.86
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB = 8, 1024, 8, 2
TRAIN_STEPS, TRAIN_LEG_STEPS, TRAIN_SAFE_PCS = 12, 4, 25
TRAIN_CHECK_STEP = 3
# The cell's AdamW: peak 1e-4 after 2 warmup steps.  This init starts at
# the uniform floor (ln(128,256) + 0.014); at 3e-4 its loss rises within
# 12 steps, with or without a plan, and at 1e-4 it falls on the training
# and held-out batches (scripts/train_lr_probe.py).
TRAIN_LR = 1e-4
# The traced step of the cell (not among the timed steps 3-12).
TRAIN_TRACE_STEP = 1
# The cheap domain of the timed cell, with ECC: a reckoning from the
# fault map's thresholds gives about 3,200 corrected and 0.16
# uncorrectable codewords per pass over the 8-layer parameter arena
# (0.91 V: about 116,000 and 200; PERF.md has the counts measured).
# Unprotected (K1) at V_TRAIN, ~90,000 words of the arena change per pass.
V_TRAIN_ECC = 0.94
V_TRAIN = 0.91
# card vs CPU, float32 (TF32 off): relative loss difference
TRAIN_LOSS_RTOL = 1e-4
T3_STEPS, T3_SAVE_AT = 3, 5
T3_BUDGETS = (1.0, 0.75, 0.6, 0.55, 0.65, 0.85)
T4_STEPS = 5


class ArenaRecorder:
    """Keeps the operands and results of the K1 / K2 calls the arena
    engine makes while ``armed`` (the recorded arena is the packed
    post-AdamW words, which the engine does not write again), so each
    can be held against its plain version on the same words."""

    NAMES = ("arena_bitflip", "arena_ecc")

    def __init__(self, flag_ecc: bool = False):
        from repro_torch.core import engine
        self.engine = engine
        self.armed = False
        self.calls = []
        # with ``flag_ecc``, every K2 call's uncorrectable codewords (see
        # flagged_codewords), armed or not, in call order
        self.flag_ecc = flag_ecc
        self.flagged = []
        self.n_calls = 0

    def __enter__(self):
        self.orig = {n: getattr(self.engine, n) for n in self.NAMES}
        for name, fn in self.orig.items():
            setattr(self.engine, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.engine, name, fn)

    def _wrap(self, name, fn):
        def run(arena, block_base, block_thr, **kw):
            out = fn(arena, block_base, block_thr, **kw)
            if name == "arena_ecc" and self.flag_ecc:
                self.flagged.extend(
                    dict(call=self.n_calls, **cw) for cw in
                    flagged_codewords(arena, block_base, block_thr, out, kw))
                self.n_calls += 1
            if self.armed:
                self.calls.append((name, arena, block_base, block_thr, kw,
                                   out))
            return out
        return run

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def flagged_codewords(arena, block_base, block_thr, out, kw):
    """Every codeword a K2 call counted uncorrectable: its block, the
    block's base word, its own word id, the stored (pre-injection) words,
    K2's output words and the block's threshold row, found by the plain
    per-codeword path over the flagged blocks (which must flag exactly
    K2's per-block counts)."""
    import torch
    from repro_torch.core import hashing as H
    from repro_torch.kernels.bitflip.bitflip import BLOCK_WORDS, block_word_ids
    from repro_torch.kernels.ecc.ecc import arena_ecc_events
    from repro_torch.core import faultmap as fm
    bad = out[1]
    found = []
    for b in torch.nonzero(bad).flatten().tolist():
        words = arena[b * BLOCK_WORDS:(b + 1) * BLOCK_WORDS]
        base = H.as_u64(block_base[b:b + 1])
        thr = H.as_u64(block_thr[b:b + 1])
        row = tuple(thr[:, c][:, None] for c in range(fm.NUM_THR_COLS))
        _, _, unc = arena_ecc_events(H.as_u64(words[None]),
                                     block_word_ids(base), row, **kw)
        js = torch.nonzero(unc[0]).flatten().tolist()
        if len(js) != int(bad[b]):
            raise AssertionError(f"K2 counted {int(bad[b])} uncorrectable "
                                 f"codewords in block {b}, the plain path "
                                 f"{len(js)}")
        outw = out[0][b * BLOCK_WORDS:(b + 1) * BLOCK_WORDS]
        for j in js:
            found.append(dict(
                block=b, base_word=int(base[0]) & H.MASK,
                word_id=(int(base[0]) + 2 * j) & H.MASK,
                stored=[int(w) & H.MASK for w in words[2 * j:2 * j + 2]],
                out=[int(w) & H.MASK for w in outw[2 * j:2 * j + 2]],
                thr_row=[int(t) & H.MASK for t in block_thr[b].tolist()]))
    return found


def check_arena_call(label, call, thr_want=None) -> int:
    """A recorded K1 / K2 call against its plain version on the same
    words (bits, and K2's per-block counts); returns the words it
    changed.  ``thr_want``: the threshold rows the call must have used."""
    import torch
    from repro_torch.kernels.bitflip.bitflip import arena_bitflip_ref
    from repro_torch.kernels.ecc.ecc import arena_ecc_ref
    name, arena, bb, bt, kw, out = call
    if thr_want is not None and not torch.equal(bt, thr_want):
        raise AssertionError(f"{label}: {name} ran other threshold rows "
                             "than the step's voltage gives")
    if name == "arena_bitflip":
        ref = arena_bitflip_ref(arena, bb, bt, **kw)
        if not torch.equal(ref, out):
            raise AssertionError(f"{label}: K1 != its plain version")
        got = out
    else:
        ref = arena_ecc_ref(arena, bb, bt, **kw)
        for a, b, what in zip(out, ref, ("words", "uncorrectable",
                                         "corrected")):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: K2 {what} != plain")
        got = out[0]
    return int((got != arena).sum())


class StepTimer:
    """CUDA events around a train step and, inside it, AdamW's update and
    the plan's injection (``UndervoltPlan.apply``): forward + backward is
    the time before the update starts."""

    def __enter__(self):
        import torch
        from repro_torch.optim import adamw
        from repro_torch.training.undervolt import UndervoltPlan
        self.adamw, self.plan_cls = adamw, UndervoltPlan
        self.orig = (adamw.update, UndervoltPlan.apply)
        self.ev = {}

        def mark(key):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.ev[key] = e

        def update(*a, **kw):
            mark("adamw0")
            out = self.orig[0](*a, **kw)
            mark("adamw1")
            return out

        def apply(plan, *a, **kw):
            mark("inject0")
            out = self.orig[1](plan, *a, **kw)
            mark("inject1")
            return out

        self.mark = mark
        adamw.update = update
        UndervoltPlan.apply = apply
        return self

    def __exit__(self, *exc):
        self.adamw.update, self.plan_cls.apply = self.orig

    def step(self, step, state, batch):
        """Run one step; returns (state, metrics, split ms)."""
        import torch
        self.ev = {}
        t0 = time.perf_counter()
        self.mark("start")
        state, m = step(state, batch)
        self.mark("end")
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        e = self.ev
        split = {"wall_ms": wall,
                 "device_ms": e["start"].elapsed_time(e["end"]),
                 "fwd_bwd_ms": e["start"].elapsed_time(e["adamw0"]),
                 "adamw_ms": e["adamw0"].elapsed_time(e["adamw1"])}
        if "inject0" in e:
            split["inject_ms"] = e["inject0"].elapsed_time(e["inject1"])
        return state, m, split


def trace_train_step(label: str, run):
    """``run()`` (one train step) under torch.profiler: returns its result
    and :func:`_trace_metrics` of the step (busy, idle share of its
    window, device ops, host us per op, top 8 ops by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{label}.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("train_step"):
            out = run()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    m = _trace_metrics(path, "train_step", n_top=8)
    path.unlink()
    if m["idle_share"] is None or not 0.0 <= m["idle_share"] <= 1.0:
        raise AssertionError(f"trace[{label}]: idle share {m['idle_share']}")
    log(f"trace[{label}]: window {m['window_ms']:.1f} ms, device busy "
        f"{m['busy_ms']:.1f} ms, idle share {m['idle_share']:.3f}, "
        f"{m['device_ops_per_step']:.0f} device ops, host "
        f"{m['host_us_per_op']:.2f} us per op; top by device ms: "
        f"{m['top_ms_per_step']}")
    return out, m


def state_to(state, dev):
    """A copy of a train state on ``dev`` (the step sets requires_grad)."""
    from repro_torch.core import pytree
    return pytree.tree_map(lambda t: t.detach().to(dev, copy=True), state)


def states_bits_equal(a, b) -> bool:
    """Two train states equal on bits, leaf by leaf on the host."""
    from repro_torch.core import pytree
    la, lb = pytree.leaves(a), pytree.leaves(b)
    return len(la) == len(lb) and all(
        bits_equal(x.detach().cpu(), y.detach().cpu()) for x, y in zip(la, lb))


def losses_agree(label, card, cpu) -> float:
    """Card losses finite and within TRAIN_LOSS_RTOL of the CPU's; returns
    the largest relative difference."""
    import math
    if not all(math.isfinite(x) for x in card + cpu):
        raise AssertionError(f"{label}: non-finite loss, card {card}, CPU "
                             f"{cpu}")
    err = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    if err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{label}: card losses {card} != CPU {cpu} "
                             f"(rel {err:.2e} > {TRAIN_LOSS_RTOL})")
    return err


def train_quickstart_phase(dev):
    """T1: the quickstart on the card (its own assertion, one K1 launch
    per step), its float32 twin on the card against the CPU, and K1 at
    one step against its plain version on the same words."""
    import torch
    from repro_torch.examples import quickstart
    from repro_torch.kernels import _build
    from repro_torch.models.base import get_arch
    from repro_torch.training import trainer
    from repro_torch.training.undervolt import aggressive_plan
    from repro_torch.data.pipeline import make_batch
    t0 = time.perf_counter()
    _build.reset_launch_counts()            # the quickstart's path
    loss = quickstart.main(["--device", str(dev)])
    counts = _build.launch_counts()
    qs_s = time.perf_counter() - t0
    if counts.get("arena_bitflip", 0) != quickstart.STEPS or counts.get(
            "arena_ecc", 0):
        raise AssertionError(f"T1: quickstart launched {counts}, want "
                             f"{quickstart.STEPS} K1 (one per step)")
    log(f"T1 quickstart on the card: final loss {loss:.4f} (< 5.0), "
        f"{quickstart.STEPS} steps in {qs_s:.1f} s, launches {counts}")

    bundle = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(bundle.reduced, dtype=torch.float32)
    tc = quickstart.train_config()
    dc = quickstart.data_config(cfg.vocab)
    init = trainer.init_state(bundle, cfg, torch.Generator().manual_seed(0),
                              device="cpu")

    def run(device, recorder=None):
        step = trainer.make_train_step(bundle, cfg, tc)
        state, losses = state_to(init, device), []
        for i in range(T1_F32_STEPS):
            if recorder is not None:
                recorder.armed = i == T1_CHECK_STEP
            state, m = step(state, trainer.device_batch(make_batch(dc, i),
                                                        device))
            losses.append(float(m["loss"]))
        return state, losses

    _, cpu = run(torch.device("cpu"))
    with ArenaRecorder() as rec:
        state, card = run(dev, rec)
        calls = rec.take()
        if len(calls) != 1:
            raise AssertionError(f"T1 f32: {len(calls)} K1 calls at step "
                                 f"{T1_CHECK_STEP}, want 1")
        changed = check_arena_call("T1 f32 0.93 V", calls[0])
        deep_changed = None
        if changed == 0:
            deep = trainer.TrainConfig(
                microbatches=tc.microbatches, adamw=tc.adamw,
                undervolt=aggressive_plan(v_unsafe=T1_DEEP_V,
                                          mitigation="none",
                                          geometry=tc.undervolt.geometry),
                undervolt_method="word")
            rec.armed = True
            trainer.make_train_step(bundle, cfg, deep)(
                state, trainer.device_batch(make_batch(dc, T1_F32_STEPS),
                                            dev))
            deep_changed = check_arena_call(f"T1 f32 {T1_DEEP_V} V",
                                            rec.take()[0])
            if deep_changed == 0:
                raise AssertionError(f"T1: K1 changed no word at "
                                     f"{T1_DEEP_V} V")
    err = losses_agree("T1 f32", card, cpu)
    log(f"T1 f32 twin: {T1_F32_STEPS} steps, card losses {card} vs CPU "
        f"{cpu} (max rel {err:.2e} <= {TRAIN_LOSS_RTOL}); K1 == plain at "
        f"step {T1_CHECK_STEP} on bits, {changed} words changed at 0.93 V"
        + ("" if deep_changed is None else
           f", {deep_changed} at {T1_DEEP_V} V (word)"))
    return {"final_loss": loss, "seconds": qs_s, "launches": counts,
            "f32_card_losses": card, "f32_cpu_losses": cpu,
            "f32_max_rel": err, "k1_changed_words": changed,
            "k1_changed_words_deep": deep_changed}


def train_plan(v: float, ecc: bool = False):
    """T2's plan: the moments on TPU_V5E's 25 most reliable PCs at V_MIN,
    the parameters on the other 7 at ``v`` (clamp mitigation)."""
    from repro_torch.core.domains import MemoryDomain
    from repro_torch.core.faultmap import PAPER_MAP_SEED
    from repro_torch.core.faultmodel import V_MIN
    from repro_torch.core.hbm import TPU_V5E
    from repro_torch.training.undervolt import UndervoltPlan, _fault_map
    fmap = _fault_map(TPU_V5E, PAPER_MAP_SEED)
    order = [int(p) for p in fmap.usable_pcs(v, 1.0)]
    order += [p for p in range(TPU_V5E.num_pcs) if p not in order]
    return UndervoltPlan(
        domains={"safe": MemoryDomain("safe", V_MIN,
                                      tuple(order[:TRAIN_SAFE_PCS])),
                 "cheap": MemoryDomain("cheap", v,
                                       tuple(order[TRAIN_SAFE_PCS:]),
                                       ecc=ecc)},
        policy={"params": "cheap", "mu": "safe", "nu": "safe"},
        geometry=TPU_V5E, mitigation="clamp")


def train_full_width_phase(dev, ops_per_word):
    """T2: full-width llama3.2-3b cut to 8 layers trains under the plan.
    The cell: 12 steps with ECC on the cheap domain at V_TRAIN_ECC, where
    the fault map predicts thousands of corrected and fewer than one
    uncorrectable codeword in the parameter arena: one K2 launch per
    step, K2 == plain at one step (words and counts), corrected faults
    every step, a finite and falling loss; timed and split.  Then 4 steps
    with the cheap domain unprotected at V_TRAIN (K1, word): one launch
    per step, K1 == plain at one step with words changed, K1 timed over
    the parameter arena beside its bound; its losses are reported, not
    gated (stuck exponent bits in unprotected bf16 weights).  Then 4
    steps with every domain at V_MIN == 4 steps with no plan, on bits
    (deterministic algorithms), launching nothing."""
    import math
    import numpy as np
    import torch
    from repro_torch.core import pytree
    from repro_torch.core.domains import CapacityError
    from repro_torch.core.faultmodel import V_MIN
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitflip.bitflip import arena_bitflip
    from repro_torch.models.base import get_arch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import trainer
    bundle = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(bundle.cfg, n_layers=TRAIN_LAYERS)
    deeper = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS + 1)
    try:
        trainer._placements(bundle, deeper,
                            trainer.TrainConfig(undervolt=train_plan(V_TRAIN)))
        raise AssertionError(f"T2: {TRAIN_LAYERS + 1} layers placed; the "
                             "depth cut is not the deepest that fits")
    except CapacityError as e:
        log(f"T2 depth: {TRAIN_LAYERS + 1} layers do not fit the plan ({e})")
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH, seed=7)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=2)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    eval_loss = trainer.make_eval_loss(bundle, cfg)
    held = {k: v[:TRAIN_BATCH // TRAIN_MB] for k, v in trainer.device_batch(
        make_batch(dc, 10_000), dev).items()}

    def leg(key, desc, plan, steps, check_step=None, timer=None):
        """Train ``steps`` steps from the seeded init under ``plan``;
        returns (state, per-step record, launches, recorded calls).  A
        timed leg also evaluates a held-out batch before and after and
        traces step TRAIN_TRACE_STEP."""
        state = trainer.init_state(
            bundle, cfg, torch.Generator(device=dev).manual_seed(0),
            device=dev)
        step = trainer.make_train_step(bundle, cfg, trainer.TrainConfig(
            microbatches=TRAIN_MB, adamw=opt, undervolt=plan))
        rec_ = {"losses": [], "grad_norm": [], "corrected": [],
                "uncorrectable": [], "splits": []}
        if timer is not None:
            rec_["held_out"] = [float(eval_loss(state["params"], held))]
        _build.reset_launch_counts()        # the leg's path starts here
        with ArenaRecorder(flag_ecc=key == "cell") as rec:
            for i in range(steps):
                rec.armed = i == check_step
                b = trainer.device_batch(make_batch(dc, i), dev)
                if timer is None:
                    state, m = step(state, b)
                elif i == TRAIN_TRACE_STEP:
                    (state, m, split), rec_["trace"] = trace_train_step(
                        f"train_step_{key}",
                        lambda: timer.step(step, state, b))
                else:
                    state, m, split = timer.step(step, state, b)
                if timer is not None:
                    rec_["splits"].append(split)
                rec_["losses"].append(float(m["loss"]))
                rec_["grad_norm"].append(float(m["grad_norm"]))
                rec_["corrected"].append(int(m.get("corrected_faults", 0)))
                rec_["uncorrectable"].append(
                    int(m.get("uncorrectable_faults", 0)))
            counts = _build.launch_counts()  # ... and ends here
            calls = rec.take()
            rec_["flagged"] = rec.flagged
        if timer is not None:
            rec_["held_out"].append(float(eval_loss(state["params"], held)))
            rest = rec_["splits"][2:] or rec_["splits"]
            rec_["split_ms"] = {k: float(np.median([x[k] for x in rest]))
                                for k in rest[0]}
            rec_["ms_per_step"] = rec_["split_ms"]["wall_ms"]
            rec_["tokens_per_s"] = tokens / (rec_["ms_per_step"] / 1e3)
            sp = rec_["split_ms"]
            log(f"T2 {key} ({desc}): ms/step {sp['wall_ms']:.1f} (median of steps "
                f"{min(3, steps)}-{steps}; forward+backward "
                f"{sp['fwd_bwd_ms']:.1f}, AdamW {sp['adamw_ms']:.1f}, "
                f"injection {sp.get('inject_ms', 0.0):.1f}, device "
                f"{sp['device_ms']:.1f}), {rec_['tokens_per_s']:.0f} "
                f"tokens/s")
        log(f"T2 {key} ({desc}): held-out loss {rec_.get('held_out')}, losses "
            f"{rec_['losses']}, grad_norm "
            f"{rec_['grad_norm']}, corrected {rec_['corrected']}, "
            f"uncorrectable {rec_['uncorrectable']}, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        return state, rec_, counts, calls

    def one_per_step(key, counts, name, steps):
        other = {k: v for k, v in counts.items() if v and k != name}
        if counts.get(name, 0) != steps or other:
            raise AssertionError(f"T2 {key}: launches {counts}, want one "
                                 f"{name} per step")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with StepTimer() as timer:
        state, cell, ecc_counts, calls = leg(
            "cell", f"{V_TRAIN_ECC} V ECC", train_plan(V_TRAIN_ECC, ecc=True),
            TRAIN_STEPS, TRAIN_CHECK_STEP, timer)
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(p.numel() for p in pytree.leaves(state["params"]))
    del state
    one_per_step("cell", ecc_counts, "arena_ecc", TRAIN_STEPS)
    _, _, _, _, _, (_, bad_blocks, corr_blocks) = calls[0]
    check_arena_call("T2 cell (K2)", calls[0])
    k = TRAIN_CHECK_STEP
    if (int(corr_blocks.sum()) != cell["corrected"][k]
            or int(bad_blocks.sum()) != cell["uncorrectable"][k]):
        raise AssertionError("T2 cell: the step's counts != K2's")
    del calls, bad_blocks, corr_blocks
    losses, held_out = cell["losses"], cell["held_out"]
    if (not all(math.isfinite(x) for x in losses + held_out)
            or losses[-1] >= losses[0] or held_out[1] >= held_out[0]):
        raise AssertionError(f"T2 cell: losses {losses} (held-out "
                             f"{held_out}) not finite and falling")
    if min(cell["corrected"]) <= 0:
        raise AssertionError(f"T2 cell: corrected {cell['corrected']}")
    # Each uncorrectable codeword of the cell, on a line of its own: the
    # operands of tests/test_torch_ecc_codewords.py's plain == reference
    # check.
    table = train_plan(V_TRAIN_ECC, ecc=True).fault_map().threshold_table(
        V_TRAIN_ECC)
    per_step = [0] * TRAIN_STEPS
    for cw in cell["flagged"]:
        row = torch.tensor(cw["thr_row"], dtype=torch.int64)
        cw["pc"] = [p for p in range(table.shape[0])
                    if torch.equal(table[p].long() & 0xFFFFFFFF, row)]
        per_step[cw["call"]] += 1
        log("T2 uncorrectable codeword: " + json.dumps(cw))
    if per_step != cell["uncorrectable"]:
        raise AssertionError(f"T2 cell: flagged codewords per step "
                             f"{per_step} != the step's counts "
                             f"{cell['uncorrectable']}")
    torch.cuda.empty_cache()

    with StepTimer() as timer:
        _, word, k1_counts, calls = leg(
            "word", f"{V_TRAIN} V unprotected, K1", train_plan(V_TRAIN),
            TRAIN_LEG_STEPS, 1, timer)
    one_per_step("word", k1_counts, "arena_bitflip", TRAIN_LEG_STEPS)
    _, arena, bb, bt, kw, _ = calls[0]
    t0 = time.perf_counter()
    changed = check_arena_call("T2 word", calls[0])
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if changed == 0:
        raise AssertionError(f"T2: K1 changed no word at {V_TRAIN} V")
    k1_ms = cuda_ms(lambda: arena_bitflip(arena, bb, bt, **kw), reps=5,
                    queue_s=QUEUE_S)
    n_words = arena.numel()
    k1_bound, k1_by = bound(8.0 * n_words + 4.0 * (bb.numel() + bt.numel()),
                            int_ops=n_words * ops_per_word["word"])
    del calls, arena, bb, bt
    torch.cuda.empty_cache()
    log(f"T2 K1 over the parameter arena ({n_words} words): "
        f"{k1_ms:.4f} ms (bound {k1_bound:.4f} ms by {k1_by}), plain "
        f"{plain_ms:.1f} ms (one call, host clock), == plain at step 1 "
        f"with {changed} words changed")

    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for key, plan in (("guardband", train_plan(V_MIN)), ("none", None)):
            state, _, counts, _ = leg(key, "deterministic", plan,
                                      TRAIN_LEG_STEPS)
            if sum(counts.values()):
                raise AssertionError(f"T2 {key}: launches {counts}")
            runs[key] = state_to(state, torch.device("cpu"))
            del state
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    if not states_bits_equal(runs["guardband"], runs["none"]):
        raise AssertionError("T2: guardband state != no-plan state")
    del runs
    log(f"T2 guardband: {TRAIN_LEG_STEPS} steps at V_MIN launch nothing and "
        "equal the no-plan run on bits (params, moments, step)")
    report = {"layers": TRAIN_LAYERS, "params": n_params,
              "peak_bytes": peak, "cell": cell, "word": word,
              "k1_ms": k1_ms, "k1_bound_ms": k1_bound, "k1_bound_by": k1_by,
              "k1_plain_ms": plain_ms, "k1_words": n_words,
              "k1_changed_words": changed}
    log(f"T2 full width: {TRAIN_LAYERS} layers, {n_params / 1e9:.3f} B "
        f"params, batch {TRAIN_BATCH} x {TRAIN_SEQ}, microbatches "
        f"{TRAIN_MB}: peak {peak / 2**30:.2f} GiB allocated")
    return report, {"arena_bitflip": k1_counts.get("arena_bitflip", 0),
                    "arena_ecc": ecc_counts.get("arena_ecc", 0)}


def train_checkpoint_governor_phase(dev):
    """T3 (reduced llama3.2-3b, bf16, the quickstart's configuration):
    save at step 5, then 3 steps on; restore and the same 3 steps: equal
    losses and state bits (deterministic algorithms).  Then a governed
    run whose power budget moves every step: governor_voltage follows the
    reference mapping and every K1 call used that voltage's thresholds
    and equals its plain version."""
    import tempfile
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.core import engine
    from repro_torch.core.faultmodel import V_MIN
    from repro_torch.core.hbm import VCU128
    from repro_torch.data.pipeline import make_batch
    from repro_torch.examples import quickstart
    from repro_torch.models.base import get_arch
    from repro_torch.training import trainer
    from repro_torch.training.undervolt import aggressive_plan
    bundle = get_arch("llama3.2-3b")
    cfg = bundle.reduced
    tc = quickstart.train_config()
    dc = quickstart.data_config(cfg.vocab)
    step = trainer.make_train_step(bundle, cfg, tc)

    def run(state, start, n):
        losses = []
        for i in range(start, start + n):
            state, m = step(state, trainer.device_batch(make_batch(dc, i),
                                                        dev))
            losses.append(float(m["loss"]))
        return state, losses

    torch.use_deterministic_algorithms(True)
    try:
        state, _ = run(trainer.init_state(
            bundle, cfg, torch.Generator(device=dev).manual_seed(0),
            device=dev), 0, T3_SAVE_AT)
        with tempfile.TemporaryDirectory() as d:
            ckpt.save(d, T3_SAVE_AT, state)
            cont, l_cont = run(state_to(state, dev), T3_SAVE_AT, T3_STEPS)
            restored, meta = ckpt.restore(d, state)
        rest, l_rest = run(restored, meta["step"], T3_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
    if l_cont != l_rest or not states_bits_equal(cont, rest):
        raise AssertionError(f"T3: restored continuation {l_rest} != "
                             f"uninterrupted {l_cont} (or state bits)")
    log(f"T3 checkpoint: restore at step {T3_SAVE_AT} + {T3_STEPS} steps == "
        f"uninterrupted on losses {l_cont} and state bits")

    plan = aggressive_plan(v_unsafe=0.91, mitigation="none", geometry=VCU128)
    gov = plan.make_governor("cheap", mode="power", tolerable_rate=1e-3)
    gtc = trainer.TrainConfig(adamw=tc.adamw, undervolt=plan, governor=gov,
                              governor_key="power_budget",
                              undervolt_method="word")
    gstep = trainer.make_train_step(bundle, cfg, gtc)
    placement = trainer._placements(bundle, cfg, gtc)["params"]
    block_pc = engine._block_arrays(placement)[0]
    state = trainer.init_state(bundle, cfg,
                               torch.Generator(device=dev).manual_seed(1),
                               device=dev)
    volts, changed = [], []
    with ArenaRecorder() as rec:
        rec.armed = True
        for i, budget in enumerate(T3_BUDGETS):
            b = trainer.device_batch(make_batch(dc, i), dev)
            state, m = gstep(state, {**b, "power_budget": budget})
            v = m["governor_voltage"]
            if v != gov.voltage_at(budget):
                raise AssertionError(f"T3 governor: voltage {v} at budget "
                                     f"{budget}")
            volts.append(v)
            calls = rec.take()
            if len(calls) != (1 if v < V_MIN - 1e-9 else 0):
                raise AssertionError(f"T3 governor: {len(calls)} K1 calls "
                                     f"at {v} V")
            for call in calls:
                changed.append(check_arena_call(
                    f"T3 governor {v} V", call,
                    engine.block_thresholds(plan.fault_map(), v, block_pc,
                                            dev)))
    if len(set(volts)) < 3 or not changed:
        raise AssertionError(f"T3 governor: voltages {volts} did not move")
    log(f"T3 governor: budgets {T3_BUDGETS} -> voltages {volts}; each K1 "
        f"call used its step's thresholds and == plain, words changed "
        f"{changed}")
    return {"losses": l_cont, "governor_voltages": volts,
            "governor_changed_words": changed}


def train_hybrid_phase(dev):
    """T4: reduced recurrentgemma-9b in float32: forward_train and 5
    train steps on the card within TRAIN_LOSS_RTOL of the CPU."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.base import get_arch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import trainer
    bundle = get_arch("recurrentgemma-9b")
    cfg = dataclasses.replace(bundle.reduced, dtype=torch.float32)
    dc = DataConfig(vocab=cfg.vocab, seq_len=48, global_batch=4, seed=5)
    init = trainer.init_state(bundle, cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    tc = trainer.TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=2,
                                               total_steps=50))

    def run(device):
        state = state_to(init, device)
        with torch.no_grad():
            first, _ = bundle.module.forward_train(
                state["params"], trainer.device_batch(make_batch(dc, 0),
                                                      device), cfg)
        step = trainer.make_train_step(bundle, cfg, tc)
        losses = [float(first)]
        for i in range(T4_STEPS):
            state, m = step(state, trainer.device_batch(make_batch(dc, i),
                                                        device))
            losses.append(float(m["loss"]))
        return losses

    cpu, card = run(torch.device("cpu")), run(dev)
    err = losses_agree("T4", card, cpu)
    log(f"T4 reduced recurrentgemma f32: forward_train + {T4_STEPS} steps, "
        f"card {card} vs CPU {cpu} (max rel {err:.2e} <= {TRAIN_LOSS_RTOL})")
    return {"card_losses": card, "cpu_losses": cpu, "max_rel": err}


# ------------------------------------------------------------- model zoo
# G: gemma3-4b at full width (34 layers: 29 sliding-window rings of 1024,
# 5 global rings), generate() with a prompt past the window (the local
# rings wrap) and the paged scheduler whose chunked prefill crosses the
# window.  Y: the dense zoo's head shapes (llama3-8b G 4, yi-34b G 7,
# D 128) at the kernels, llama3-8b at full width through generate().  M:
# deepseek-v2-lite-16b at full width (MLA latent rings, 64 routed experts)
# through generate() and the state-arena scheduler, and its expert
# tiering at full width cut in depth to what the plan can place.
ZOO_B, ZOO_PROMPT, ZOO_NEW, ZOO_MAX_LEN = 4, 1536, 32, 2048
ZOO_SCHED_PROMPTS = (96, 1536, 640, 1100, 300, 1280)
ZOO_SCHED_NEW = (16, 24, 12, 20, 32, 8)
# llama3-8b generate(): batch 4, 512-token prompts, 32 new, rings of 1024
Y_PROMPT, Y_MAX_LEN = 512, 1024
# deepseek-v2-lite: generate() batch 4 x 512 (32 new), the state arena 3
# slots and 6 requests in rings of 1536
M_PROMPT, M_MAX_LEN = 512, 1024
M_SLOTS, M_SCHED_MAX_LEN = 3, 1536
M_SCHED_PROMPTS = (128, 1024, 384, 640, 256, 896)
M_SCHED_NEW = (8, 24, 16, 12, 20, 10)
# expert tiering: the plan's unsafe domain voltage, the depth cut (the
# deepest whose 64 experts' weights place on aggressive_plan's TPU_V5E
# domains: 16 layers, 15 of them MoE, 8.3 B expert params; 17 raise
# CapacityError, checked every run) and the traffic (each request replayed
# alone on sched.params)
M_TIER_V = V_DENSE
M_TIER_LAYERS = 16
M_TIER_PROMPTS = (64, 256, 128, 192)
M_TIER_NEW = (8, 12, 6, 10)
M_TIER_MAX_LEN = 512


def zoo_model(dev, arch, n_layers=None):
    """``arch`` at full width (depth ``n_layers`` if given), bf16, weights
    from a seeded generator."""
    import torch
    from repro_torch.models.base import get_arch, init_params
    bundle = get_arch(arch)
    cfg = bundle.cfg if n_layers is None else dataclasses.replace(
        bundle.cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(bundle.module.param_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in _leaves(params))
    log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n / 1e9:.2f} B params ({2 * n / 1e9:.1f} GB bf16) made in "
        f"{time.perf_counter() - t0:.1f} s")
    return bundle, cfg, params


def _leaves(tree):
    from repro_torch.core import pytree
    return pytree.leaves(tree)


def zoo_head_shape_phase(dev, ops_per_word):
    """K3 and K4 at the zoo's head shapes: gemma3-4b's window ring (1024
    slots, window 1024) and global ring (2048), D 256, G 2; llama3-8b
    (G 4) and yi-34b (G 7), D 128, rings of 1024.  For each, 4 slots of a
    shuffled page pool (pages of 8) read at 0.88 V (word) through K4:
    == its plain version (bf16 tolerance), == K3 over the same words in
    ring order at a tile of one page (bits, injection on and off); K3 at
    generate()'s tile over the 4 rows == its plain version and == each
    row alone (bits); K3 and K4 timed per layer beside their bound and
    SDPA.  Returns {shape: report}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import hashing as H
    from repro_torch.kernels.flash_attention import faulty
    from repro_torch.models.base import get_arch
    from repro_torch.serving.paged import PagePool
    S, PS, v = SLOTS, PAGE_SLOTS, V_DENSE
    out = {}
    for name, arch, ring, max_len, local in (
            ("gemma3_window", "gemma3-4b", None, ZOO_MAX_LEN, True),
            ("gemma3_global", "gemma3-4b", ZOO_MAX_LEN, ZOO_MAX_LEN, False),
            ("llama3_8b", "llama3-8b", Y_MAX_LEN, Y_MAX_LEN, False),
            ("yi_34b", "yi-34b", Y_MAX_LEN, Y_MAX_LEN, False)):
        bundle = get_arch(arch)
        cfg = bundle.cfg
        window = cfg.window if local else 0
        ring = ring or cfg.window
        cfg1 = dataclasses.replace(cfg, n_layers=len(cfg.pattern or (1,)))
        H_, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        G = H_ // KH
        n_lp_all = max_len // PS
        num_pages = S * n_lp_all
        pool = PagePool(bundle.module, cfg1, max_len=max_len, page_slots=PS,
                        num_pages=num_pages, plan=plan_at(v))
        fmap = pool.faultmap
        thr = fmap.threshold_table(v)
        tabs = {}
        for leaf in pool.leaves:
            if leaf.which in ("k", "v") and leaf.length == ring:
                tabs[leaf.which] = (
                    H.as_i32(torch.from_numpy(
                        leaf.page_base[0].astype("int64"))).to(dev),
                    thr[torch.from_numpy(leaf.page_pc[0].astype(
                        "int64"))].to(dev).contiguous())
        n_lp = ring // PS
        gen = torch.Generator(device=dev).manual_seed(11)
        total = num_pages + 1
        pool_k = torch.randn((total, PS, KH, D), generator=gen,
                             device=dev).to(torch.bfloat16)
        pool_v = torch.randn((total, PS, KH, D), generator=gen,
                             device=dev).to(torch.bfloat16)
        q = torch.randn((S, 1, H_, D), generator=gen, device=dev).to(
            torch.bfloat16)
        perm = torch.randperm(num_pages,
                              generator=torch.Generator().manual_seed(5))
        ptab = perm.reshape(S, n_lp_all).to(torch.int32).to(dev)
        ptab_ring = ptab[:, :n_lp].contiguous()
        # slot 0 has wrapped its ring (decodes at ring + 5); the others hold
        # positions 0..fill-1 and decode at fill
        fill = [ring, ring - ring // 25, 2 * ring // 3, ring // 3]
        q_pos = torch.tensor([ring + 5] + fill[1:], dtype=torch.int32,
                             device=dev)
        pos_pool = torch.full((total, PS), -1, dtype=torch.int32, device=dev)
        r_ = torch.arange(ring, dtype=torch.int32, device=dev)
        for s_, f in enumerate(fill):
            pos_pool[ptab_ring[s_].long()] = torch.where(
                r_ < f, r_, -1).reshape(n_lp, PS)
        pos_pool[ptab_ring[0].long()] = torch.where(
            r_ < 5, r_ + ring, r_).reshape(n_lp, PS)
        kw = dict(seed=fmap.seed, method="word",
                  words_per_row_log2=fmap.words_per_row_log2, ecc=False,
                  window=window)

        def k4(inject, which=faulty.paged_decode_attention):
            return which(q, pool_k, pool_v, pos_pool, ptab_ring, q_pos=q_pos,
                         k_tables=tabs["k"], v_tables=tabs["v"],
                         inject=inject, **kw)

        def rings():
            idx = ptab_ring.reshape(-1).long()
            return (pool_k[idx].reshape(S, ring, KH, D).contiguous(),
                    pool_v[idx].reshape(S, ring, KH, D).contiguous(),
                    pos_pool[idx].reshape(S, ring).contiguous(),
                    [tuple(t[ptab_ring[s_].long()].contiguous()
                           for t in tabs[w]) for s_ in range(S)
                     for w in ("k", "v")])

        rk, rv, rp, rt = rings()
        wl2 = (PS * KH * D // 2).bit_length() - 1

        def k3(s_, inject, bkv, which=faulty.faulty_decode_attention):
            return which(q[s_:s_ + 1], rk[s_:s_ + 1], rv[s_:s_ + 1],
                         rp[s_:s_ + 1], q_pos=q_pos[s_:s_ + 1],
                         k_tables=rt[2 * s_], v_tables=rt[2 * s_ + 1],
                         k_word0=0, v_word0=0, inject=inject, bkv=bkv,
                         words_log2=wl2, **kw)

        got = k4(True)
        err4 = k3_compare(f"K4 {name}", got,
                          k4(True, faulty.paged_decode_attention_ref))
        n_diff = int((got.view(torch.int16) != k4(False).view(
            torch.int16)).sum())
        if n_diff == 0:
            raise AssertionError(f"K4 {name}: injection changed no output")
        for inject in (True, False):
            ref = torch.cat([k3(s_, inject, PS) for s_ in range(S)])
            if not bits_equal(k4(inject), ref):
                raise AssertionError(f"K4 {name} inject={inject}: != K3 over "
                                     "the same words (page tiles)")
        tile = faulty.pick_bkv(ring, faulty.kv_words_per_slot(
            KH, D, torch.bfloat16))
        # K3 over the 4 rings in one launch: each row's page tables in
        # turn (row s's words start at s * ring slots)
        t4 = [tuple(torch.cat([rt[2 * s_ + w][i] for s_ in range(S)])
                    for i in (0, 1)) for w in (0, 1)]

        def k3_all(inject, which=faulty.faulty_decode_attention):
            return which(q, rk, rv, rp, q_pos=q_pos, k_tables=t4[0],
                         v_tables=t4[1], k_word0=0, v_word0=0,
                         inject=inject, bkv=None, words_log2=wl2, **kw)

        got3 = k3_all(True)
        err3 = k3_compare(f"K3 {name}", got3,
                          k3_all(True, faulty.faulty_decode_attention_ref))
        if not bits_equal(got3, torch.cat([k3(s_, True, None)
                                           for s_ in range(S)])):
            raise AssertionError(f"K3 {name}: B = 4 rows != each row alone")
        ms4 = cuda_ms(lambda: k4(True), reps=20, queue_s=QUEUE_S)
        ms4_off = cuda_ms(lambda: k4(False), reps=20, queue_s=QUEUE_S)
        ms3 = cuda_ms(lambda: k3_all(True), reps=20, queue_s=QUEUE_S)
        ms3_off = cuda_ms(lambda: k3_all(False), reps=20, queue_s=QUEUE_S)
        kv_bytes = 2 * S * ring * KH * D * 2
        io = kv_bytes + S * ring * 4 + 2 * S * H_ * D * 2
        b_ms, b_by = bound(io, int_ops=kv_bytes // 4 * (
            ops_per_word["word"] + K3_ADDR_OPS), flops=4 * S * H_ * ring * D)
        gk = rk.transpose(1, 2).contiguous()
        gv = rv.transpose(1, 2).contiguous()
        qt = q.transpose(1, 2).contiguous()
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, gk, gv, enable_gqa=True), reps=20, queue_s=QUEUE_S)
        tps, n_splits = faulty.decode_splits(ring, PS)
        out[name] = dict(arch=arch, ring=ring, window=window, kv_heads=KH,
                         group=G, head_dim=D, k4_ms=ms4, k4_off_ms=ms4_off,
                         k3_ms=ms3, k3_off_ms=ms3_off, bound_ms=b_ms,
                         bound_by=b_by,
                         sdpa_ms=sdpa, k4_max_abs_err=err4,
                         k3_max_abs_err=err3, k3_tile=tile,
                         k4_splits=n_splits, outputs_changed=n_diff)
        log(f"K3/K4 at {name} ({arch}: ring {ring}, window {window}, KH {KH}, "
            f"G {G}, D {D}, 4 slots, pages of {PS}) @ {v} V word: K4 == "
            f"plain (max abs err {err4:.3g}), K4 == K3 over the same words "
            f"(bits, injection on and off), K3 at its {tile}-slot tile == "
            f"plain (max abs err {err3:.3g}) and at B = 4 == each row alone "
            f"(bits); K4 {ms4 * 1e3:.2f} us ({n_splits} splits; no "
            f"injection {ms4_off * 1e3:.2f} us), K3 {ms3 * 1e3:.2f} us (no "
            f"injection {ms3_off * 1e3:.2f} us), bound "
            f"{b_ms * 1e3:.2f} us by {b_by}, SDPA {sdpa * 1e3:.2f} us")
        del pool_k, pool_v, rk, rv, gk, gv
        torch.cuda.empty_cache()
    return out


def zoo_generate(bundle, cfg, params, dev, prompts, max_len, plan, mode,
                 label, capture=True, keep_cache=False, extras=None):
    """One generate() request of ZOO_NEW tokens (``extras``: the family's
    batched modality inputs), timed; returns (tokens on the host,
    report)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeConfig, generate
    rb, seen = recording(bundle)
    sc = ServeConfig(max_len=max_len, max_new_tokens=ZOO_NEW, undervolt=plan,
                     kv_injection=mode)
    before = _build.launch_counts()
    timings = {}
    toks = generate(rb, cfg, params, {"tokens": prompts, **(extras or {})},
                    sc, device=dev, timings=timings, capture=capture)
    after = _build.launch_counts()
    launches = {k: after[k] - before.get(k, 0) for k in after
                if after[k] - before.get(k, 0)}
    steps = timings["steps"]
    b = prompts.shape[0]
    if toks.shape != (b, ZOO_NEW) or int(toks.min()) < 0 or int(
            toks.max()) >= cfg.vocab:
        raise AssertionError(f"{label}: bad tokens {tuple(toks.shape)}")
    rep = dict(prefill_ms=1e3 * timings["prefill"],
               inject_ms=1e3 * timings["inject"],
               decode_ms_per_token=1e3 * timings["decode"] / (ZOO_NEW - 1),
               steady_ms_per_token=steady_ms(steps),
               tokens_per_s=b * (ZOO_NEW - 1) / timings["decode"],
               mode=timings["mode"], launches=launches, captured=capture)
    log(f"{label}{'' if capture else ' (eager)'}: mode {rep['mode']}, "
        f"prefill {rep['prefill_ms']:.1f} ms, decode "
        f"{rep['decode_ms_per_token']:.2f} ms/token over the loop (steady "
        f"{rep['steady_ms_per_token']:.3f}), launches {launches}")
    if keep_cache:
        rep["cache"] = seen["cache"]
    return toks.cpu(), rep


def gemma_phases(dev, bundle, cfg, params):
    """G, generate(): batch 4, a 1536-token prompt (past the 1024-token
    window: the local rings wrap), 32 new tokens, max_len 2048, the cache
    in the 16-PC domain.  Clean, 0.98 V (== clean), 0.91 V read == write,
    0.88 V write, 0.875 V ECC read == write; the 0.88 V write request
    served again with every decode step eager gives the same tokens,
    cache words and launches; one captured decode step traced."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeConfig, generate
    gen = torch.Generator(device=dev).manual_seed(21)
    prompts = torch.randint(0, cfg.vocab, (ZOO_B, ZOO_PROMPT), generator=gen,
                            device=dev)
    phases, toks = {}, {}
    _build.reset_launch_counts()
    for key, plan, mode in (
            ("clean", None, "auto"), ("0.98", plan_at(0.98), "auto"),
            ("0.91_read", plan_at(V_FAULTY), "read"),
            ("0.91_write", plan_at(V_FAULTY), "write"),
            ("dense_write", plan_at(V_DENSE), "write"),
            ("ecc_read", plan_at(V_DENSE_ECC, True), "read"),
            ("ecc_write", plan_at(V_DENSE_ECC, True), "write")):
        toks[key], phases[key] = zoo_generate(
            bundle, cfg, params, dev, prompts, ZOO_MAX_LEN, plan, mode,
            f"gemma3 generate[{key}]", keep_cache=key == "dense_write")
    counts = _build.launch_counts()
    for a, b_ in (("0.98", "clean"), ("0.91_read", "0.91_write"),
                  ("ecc_read", "ecc_write")):
        if not torch.equal(toks[a], toks[b_]):
            raise AssertionError(f"gemma3 generate: {a} tokens != {b_}")
    etoks, eager = zoo_generate(bundle, cfg, params, dev, prompts,
                                ZOO_MAX_LEN, plan_at(V_DENSE), "write",
                                "gemma3 generate[dense_write]",
                                capture=False, keep_cache=True)
    cap = phases["dense_write"]
    if not torch.equal(etoks, toks["dense_write"]):
        raise AssertionError("gemma3 generate: captured tokens != eager")
    if not tree_bits_equal(cap.pop("cache"), eager.pop("cache")):
        raise AssertionError("gemma3 generate: captured cache words != eager")
    if cap["launches"] != eager["launches"]:
        raise AssertionError(f"gemma3 generate: captured launches "
                             f"{cap['launches']} != eager "
                             f"{eager['launches']}")
    phases["captured_vs_eager"] = dict(
        captured_ms_per_token=cap["steady_ms_per_token"],
        eager_ms_per_token=eager["steady_ms_per_token"])
    n_k3 = cfg.n_layers * (ZOO_NEW - 1)
    for key in ("0.91_read", "dense_write", "ecc_read"):
        got = phases[key]["launches"].get("faulty_decode", 0)
        if got != n_k3:
            raise AssertionError(f"gemma3 generate[{key}]: {got} K3 launches, "
                                 f"not {cfg.n_layers} per decode step")
    phases["agree_0.91_vs_clean"] = float(
        (toks["0.91_read"] == toks["clean"]).float().mean())
    log(f"gemma3 generate: 0.98 V == clean, read == write at 0.91 V and "
        f"{V_DENSE_ECC} V ECC, captured == eager at {V_DENSE} V write (tokens, "
        f"cache words, launches), K3 {cfg.n_layers} per decode step; 0.91 V "
        f"tokens equal to clean: {phases['agree_0.91_vs_clean']:.3f}")
    sc = ServeConfig(max_len=ZOO_MAX_LEN, max_new_tokens=TRACE_NEW,
                     undervolt=plan_at(V_DENSE), kv_injection="write")
    phases["trace"] = trace_decode_steps(
        "gemma3_generate_captured", lambda: generate(
            bundle, cfg, params, {"tokens": prompts[:, :256]}, sc,
            device=dev))
    torch.cuda.empty_cache()
    return counts, phases


def zoo_sched_traffic(vocab, prompts, news):
    import numpy as np
    rng = np.random.RandomState(23)
    return [(f"z{i}", rng.randint(0, vocab, (p,)).astype(np.int64), n)
            for i, (p, n) in enumerate(zip(prompts, news))]


def gemma_scheduler_phase(dev, bundle, cfg, params):
    """G, the paged scheduler: 4 slots, pages of 8, chunks of 64, 6
    requests (prompts 96..1536, most past the window) at 0.91 V read:
    each request == its solo generate(kv_placement=) replay on bits,
    decode_traces 1, K4 once per layer and step; the same traffic with
    the decode-only step eager gives the same tokens and launches.
    Returns (launches, report, the scheduler) -- the scheduler for the
    exporters."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request)
    reqs = zoo_sched_traffic(cfg.vocab, ZOO_SCHED_PROMPTS, ZOO_SCHED_NEW)
    sc = ServeConfig(max_len=ZOO_MAX_LEN, max_new_tokens=8,
                     undervolt=plan_at(V_FAULTY), kv_injection="read",
                     prefill_chunk=CHUNK)
    pages = SLOTS * (ZOO_MAX_LEN // PAGE_SLOTS)
    out = {}
    for capture in (True, False):
        sched = ContinuousBatchingScheduler(
            bundle, cfg, params, sc, num_slots=SLOTS, num_pages=pages,
            page_slots=PAGE_SLOTS, device=dev, capture=capture)
        for rid, toks, n in reqs:
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
        before = _build.launch_counts()
        t0 = time.perf_counter()
        res = sched.run()
        wall = time.perf_counter() - t0
        after = _build.launch_counts()
        launches = {k: after[k] - before.get(k, 0) for k in after
                    if after[k] - before.get(k, 0)}
        if launches.get("paged_decode") != cfg.n_layers * sched.steps:
            raise AssertionError(f"gemma3 sched: {launches} in {sched.steps} "
                                 f"steps, not K4 {cfg.n_layers} per step")
        dec = sched.step_seconds["decode"]
        mixed = sched.step_seconds["mixed"]
        st = sched.stats
        if capture and st["decode_traces"] != 1:
            raise AssertionError(f"gemma3 sched: decode_traces "
                                 f"{st['decode_traces']}")
        n_tok = sum(res[r].tokens.shape[1] for r, *_ in reqs)
        out[capture] = dict(
            toks={r: res[r].tokens for r, *_ in reqs}, launches=launches,
            row=dict(steps=sched.steps, mixed_steps=len(mixed),
                     decode_steps=len(dec),
                     mixed_step_ms=1e3 * float(np.mean(mixed)),
                     decode_step_steady_ms=steady_ms(dec),
                     decode_traces=st["decode_traces"], wall_s=wall,
                     tokens=n_tok, tokens_per_s=n_tok / wall,
                     peak_active=sched.peak_active, launches=launches),
            sched=sched, res=res)
        log(f"gemma3 sched (0.91 V read{'' if capture else ', eager'}): "
            f"{sched.steps} steps ({len(mixed)} mixed at "
            f"{out[capture]['row']['mixed_step_ms']:.1f} ms, {len(dec)} "
            f"decode-only, steady {steady_ms(dec):.3f} ms), decode_traces "
            f"{st['decode_traces']}, {n_tok / wall:.1f} tokens/s, launches "
            f"{launches}")
    cap, eag = out[True], out[False]
    if any(not np.array_equal(cap["toks"][r], eag["toks"][r])
           for r in cap["toks"]) or cap["launches"] != eag["launches"]:
        raise AssertionError("gemma3 sched: captured != eager (tokens or "
                             "launches)")
    sched, res = cap["sched"], cap["res"]
    for rid, toks, n in reqs:
        ref = generate(bundle, cfg, params,
                       {"tokens": torch.from_numpy(toks)[None]},
                       dataclasses.replace(sc, max_new_tokens=n), device=dev,
                       kv_placement=res[rid].placement)
        if not np.array_equal(ref.cpu().numpy(), res[rid].tokens):
            raise AssertionError(f"gemma3 sched request {rid}: served tokens "
                                 "!= its solo generate(kv_placement=) replay")
    log("gemma3 sched: every request == its solo generate(kv_placement=...) "
        "replay on bits; captured == eager on tokens and launches")
    row = dict(cap["row"], eager_decode_step_steady_ms=eag["row"][
        "decode_step_steady_ms"])
    del out
    torch.cuda.empty_cache()
    return cap["launches"], row, sched


def obs_phase(sched):
    """The exporters over the gemma3 scheduler: json_snapshot printed whole
    and the Prometheus page's line count (neither needs jsonschema)."""
    from repro_torch.obs import export
    snap = export.json_snapshot(sched)
    text = export.prometheus_text(sched)
    n = len(text.strip().split("\n"))
    log("obs json_snapshot: " + json.dumps(snap))
    log(f"obs prometheus_text: {n} lines")
    if snap["stats"]["decode_traces"] != 1 or "repro_decode_traces 1" \
            not in text:
        raise AssertionError("obs: the exporters lost decode_traces == 1")
    return dict(prometheus_lines=n, snapshot_keys=sorted(snap))


def dense_zoo_phase(dev):
    """Y: llama3-8b at full width (16 GB) through generate(): batch 4,
    512-token prompts, clean and 0.88 V write (K1 at admission, K3 with
    injection off every layer and step)."""
    import torch
    from repro_torch.kernels import _build
    bundle, cfg, params = zoo_model(dev, "llama3-8b")
    gen = torch.Generator(device=dev).manual_seed(22)
    prompts = torch.randint(0, cfg.vocab, (ZOO_B, Y_PROMPT), generator=gen,
                            device=dev)
    _build.reset_launch_counts()
    phases = {}
    toks = {}
    for key, plan, mode in (("clean", None, "auto"),
                            ("dense_write", plan_at(V_DENSE), "write")):
        toks[key], phases[key] = zoo_generate(
            bundle, cfg, params, dev, prompts, Y_MAX_LEN, plan, mode,
            f"llama3-8b generate[{key}]")
    counts = _build.launch_counts()
    if phases["dense_write"]["launches"].get("faulty_decode") != \
            cfg.n_layers * (ZOO_NEW - 1):
        raise AssertionError("llama3-8b: K3 not once per layer and step")
    phases["agree_write_vs_clean"] = float(
        (toks["dense_write"] == toks["clean"]).float().mean())
    del params
    torch.cuda.empty_cache()
    return counts, phases


def moe_phases(dev):
    """M: deepseek-v2-lite-16b at full width (15.7 B params) through
    generate() (batch 4, 512-token prompts, 32 new: clean and 0.88 V
    write, the latter again with every decode step eager == captured on
    tokens, latent cache words and launches; one captured step traced)
    and the state-arena scheduler (3 slots, 6 requests at 0.88 V write:
    each == its solo replay on bits, decode_traces 1, captured == the same
    traffic with every step eager on tokens, latent cache words and
    launches)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request)
    from repro_torch.serving.statearena import StateArenaScheduler
    bundle, cfg, params = zoo_model(dev, "deepseek-v2-lite-16b")
    gen = torch.Generator(device=dev).manual_seed(24)
    prompts = torch.randint(0, cfg.vocab, (ZOO_B, M_PROMPT), generator=gen,
                            device=dev)
    _build.reset_launch_counts()
    phases, toks = {}, {}
    for key, plan, mode in (("clean", None, "auto"),
                            ("dense_write", plan_at(V_DENSE), "auto")):
        toks[key], phases[key] = zoo_generate(
            bundle, cfg, params, dev, prompts, M_MAX_LEN, plan, mode,
            f"deepseek generate[{key}]", keep_cache=key == "dense_write")
    if phases["dense_write"]["mode"] != "write":
        raise AssertionError(f"deepseek: 'auto' took "
                             f"{phases['dense_write']['mode']}, not write")
    etoks, eager = zoo_generate(bundle, cfg, params, dev, prompts, M_MAX_LEN,
                                plan_at(V_DENSE), "write",
                                "deepseek generate[dense_write]",
                                capture=False, keep_cache=True)
    cap = phases["dense_write"]
    if not torch.equal(etoks, toks["dense_write"]):
        raise AssertionError("deepseek generate: captured tokens != eager")
    if not tree_bits_equal(cap.pop("cache"), eager.pop("cache")):
        raise AssertionError("deepseek generate: captured latent cache words "
                             "!= eager")
    if cap["launches"] != eager["launches"]:
        raise AssertionError("deepseek generate: captured launches != eager")
    phases["captured_vs_eager"] = dict(
        captured_ms_per_token=cap["steady_ms_per_token"],
        eager_ms_per_token=eager["steady_ms_per_token"])
    phases["agree_write_vs_clean"] = float(
        (toks["dense_write"] == toks["clean"]).float().mean())
    log(f"deepseek generate: 'auto' -> write; captured == eager at {V_DENSE} "
        "V write (tokens, latent cache words, launches); write tokens equal "
        f"to clean: {phases['agree_write_vs_clean']:.3f}")

    reqs = zoo_sched_traffic(cfg.vocab, M_SCHED_PROMPTS, M_SCHED_NEW)
    sc = ServeConfig(max_len=M_SCHED_MAX_LEN, max_new_tokens=8,
                     undervolt=plan_at(V_DENSE), kv_injection="write")

    def serve(capture):
        sched = ContinuousBatchingScheduler(bundle, cfg, params, sc,
                                            num_slots=M_SLOTS, device=dev,
                                            capture=capture)
        if not isinstance(sched, StateArenaScheduler):
            raise AssertionError("deepseek: the front door did not give "
                                 "the state arena")
        for rid, t, n in reqs:
            sched.submit(Request(rid=rid, tokens=t, max_new_tokens=n))
        before = _build.launch_counts()
        t0 = time.perf_counter()
        res = sched.run()
        wall = time.perf_counter() - t0
        after = _build.launch_counts()
        return sched, res, wall, {k: after[k] - before.get(k, 0)
                                  for k in after
                                  if after[k] - before.get(k, 0)}

    esched, eres, _, elaunch = serve(False)
    eager_ms = steady_ms(esched.step_seconds["decode"])
    ecache = esched.state["cache"]
    del esched
    sched, res, wall, launches = serve(True)
    if sched.stats["decode_traces"] != 1:
        raise AssertionError(f"deepseek sched: decode_traces "
                             f"{sched.stats['decode_traces']}")
    if (any(not np.array_equal(res[r].tokens, eres[r].tokens)
            for r, *_ in reqs) or launches != elaunch
            or not tree_bits_equal(sched.state["cache"], ecache)):
        raise AssertionError("deepseek sched: captured != eager (tokens, "
                             "latent cache words or launches)")
    del ecache
    for rid, t, n in reqs:
        ref = generate(bundle, cfg, params,
                       {"tokens": torch.from_numpy(t)[None]},
                       dataclasses.replace(sc, max_new_tokens=n), device=dev,
                       kv_placement=res[rid].placement)
        if not np.array_equal(ref.cpu().numpy(), res[rid].tokens):
            raise AssertionError(f"deepseek sched request {rid}: served "
                                 "tokens != its solo replay")
    dec = sched.step_seconds["decode"]
    n_tok = sum(res[r].tokens.shape[1] for r, *_ in reqs)
    phases["sched"] = dict(
        steps=sched.steps, step_steady_ms=steady_ms(dec),
        eager_step_steady_ms=eager_ms, wall_s=wall, tokens=n_tok,
        tokens_per_s=n_tok / wall, peak_active=sched.peak_active,
        launches=launches)
    log(f"deepseek sched (state arena, {M_SLOTS} slots, {len(reqs)} requests, "
        f"{V_DENSE} V write): {sched.steps} steps, steady "
        f"{phases['sched']['step_steady_ms']:.3f} ms (eager "
        f"{eager_ms:.3f}), decode_traces 1, "
        f"{n_tok / wall:.1f} tokens/s (admissions included); captured == "
        "eager (tokens, latent cache words, launches); every request == "
        f"its solo generate(kv_placement=...) replay; launches {launches}")
    counts = _build.launch_counts()
    del sched, res
    tsc = ServeConfig(max_len=M_MAX_LEN, max_new_tokens=TRACE_NEW,
                      undervolt=plan_at(V_DENSE), kv_injection="write")
    phases["trace"] = trace_decode_steps(
        "deepseek_generate_captured", lambda: generate(
            bundle, cfg, params, {"tokens": prompts[:, :128]}, tsc,
            device=dev))
    del params
    torch.cuda.empty_cache()
    return counts, phases


def expert_groups(cfg):
    """Each expert's weight slices across every MoE layer group, as avals
    (what ``_tier_experts`` places), for the depth search."""
    from repro_torch.models.base import Aval, spec_avals
    from repro_torch.models import moe
    stack = spec_avals(moe.param_specs(cfg))["stack"]
    groups = {}
    for ex in range(cfg.n_experts):
        tree = {}
        for cname in ("prefix", "periods", "rest"):
            for gkey, grp in stack.get(cname, {}).items():
                for w in ("we_g", "we_u", "we_d"):
                    if w in grp:
                        a = grp[w]
                        tree[f"{cname}/{gkey}/{w}"] = Aval(
                            a.shape[:-3] + a.shape[-2:], a.dtype)
        groups[f"moe_expert[{ex:03d}]"] = tree
    return groups


def tiering_plan():
    from repro_torch.training.undervolt import aggressive_plan
    return aggressive_plan(v_unsafe=M_TIER_V)


def places(cfg) -> bool:
    """Whether the experts of ``cfg`` (16 / 32 / 16 tiers) place on the
    tiering plan."""
    from repro_torch.core.domains import CapacityError, place_groups_tiered
    plan = tiering_plan()
    groups = expert_groups(cfg)
    e, q = cfg.n_experts, cfg.n_experts // 4
    tiers = {g: ("safe" if i < q else "disposable" if i >= e - q
                 else "cheap") for i, g in enumerate(sorted(groups))}
    try:
        place_groups_tiered(groups, tiers, plan.domains, plan.geometry,
                            plan.fault_map())
        return True
    except CapacityError:
        return False


def moe_tiering_phase(dev):
    """M, expert tiering at full width: the deepest deepseek-v2-lite whose
    64 experts' weights place on aggressive_plan(0.88 V) (the next layer
    must not), 3 slots; tiers 16 / 32 / 16, every K1 / K2 launch of the
    one-time expert injection == its plain version on the same words,
    every request == its solo replay on ``sched.params``, decode_traces
    1."""
    import numpy as np
    import torch
    from repro_torch.core.faultmodel import V_MIN
    from repro_torch.kernels import _build
    from repro_torch.models.base import get_arch
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request)
    full = get_arch("deepseek-v2-lite-16b").cfg
    depth = M_TIER_LAYERS
    if not places(dataclasses.replace(full, n_layers=depth)) or places(
            dataclasses.replace(full, n_layers=depth + 1)):
        raise AssertionError(f"deepseek tiering: {depth} layers are not the "
                             "deepest whose experts place")
    log(f"deepseek tiering depth: {depth} layers place, {depth + 1} raise "
        "CapacityError")
    bundle, cfg, params = zoo_model(dev, "deepseek-v2-lite-16b", depth)
    reqs = zoo_sched_traffic(cfg.vocab, M_TIER_PROMPTS, M_TIER_NEW)
    probe = np.random.RandomState(25).randint(0, cfg.vocab, (256,))
    sc = ServeConfig(max_len=M_TIER_MAX_LEN, max_new_tokens=8,
                     undervolt=tiering_plan(), kv_injection="write")
    checked = []

    class Check(ArenaRecorder):
        def _wrap(self, name, fn):
            def run(arena, block_base, block_thr, **kw):
                out = fn(arena, block_base, block_thr, **kw)
                checked.append(check_arena_call(
                    f"deepseek tiering {name}",
                    (name, arena, block_base, block_thr, kw, out)))
                return out
            return run

    _build.reset_launch_counts()
    with Check():
        t0 = time.perf_counter()
        sched = ContinuousBatchingScheduler(bundle, cfg, params, sc,
                                            num_slots=M_SLOTS, device=dev,
                                            expert_probe=probe)
        tier_s = time.perf_counter() - t0
    tier_launches = _build.launch_counts()
    tiers = sched.stats["expert_tiers"]
    q = cfg.n_experts // 4
    if tiers != {"safe": q, "cheap": cfg.n_experts - 2 * q, "disposable": q}:
        raise AssertionError(f"deepseek tiering: tiers {tiers}")
    n_inj = sum(1 for plc in sched._expert_placements.values()
                if plc.domain.voltage < V_MIN - 1e-9)
    if len(checked) != n_inj or sum(tier_launches.values()) != n_inj:
        raise AssertionError(f"deepseek tiering: {len(checked)} checked "
                             f"calls, launches {tier_launches}, {n_inj} "
                             "experts below V_MIN")
    for rid, t, n in reqs:
        sched.submit(Request(rid=rid, tokens=t, max_new_tokens=n))
    res = sched.run()
    if sched.stats["decode_traces"] != 1:
        raise AssertionError("deepseek tiering: decode_traces != 1")
    for rid, t, n in reqs:
        ref = generate(bundle, cfg, sched.params,
                       {"tokens": torch.from_numpy(t)[None]},
                       dataclasses.replace(sc, max_new_tokens=n), device=dev,
                       kv_placement=res[rid].placement)
        if not np.array_equal(ref.cpu().numpy(), res[rid].tokens):
            raise AssertionError(f"deepseek tiering request {rid}: served "
                                 "tokens != its solo replay on sched.params")
    counts = _build.launch_counts()
    report = dict(depth=depth, tiers=tiers, experts_injected=n_inj,
                  words_changed=checked, tier_s=tier_s,
                  domains={k: p.domain.name
                           for k, p in sched._expert_placements.items()},
                  tier_launches={k: v for k, v in tier_launches.items() if v})
    log(f"deepseek tiering ({depth} layers, full width): tiers {tiers}; "
        f"{n_inj} experts injected once at construction in {tier_s:.1f} s "
        f"(launches {report['tier_launches']}), each == plain, "
        f"{sum(checked)} words changed; {len(reqs)} requests each == its "
        "solo replay on sched.params; decode_traces 1")
    del sched, params
    torch.cuda.empty_cache()
    return counts, report


# ------------------------------------------------ the state-arena families
# X: xlstm-350m (12 mLSTM + 12 sLSTM layers, all state carried), W:
# whisper-large-v3 (32 encoder + 32 decoder layers, cross K/V of 1500
# frames written once at prefill), V: internvl2-2b (256 image tokens from
# 1024-wide patches before the text).  Each at full width through
# generate() (batch 4) and the state-arena scheduler (3 slots, 6
# requests at 0.88 V write), every K1 / K2 launch held against its plain
# version on the same words.  W's scheduler traffic repeats one (tokens,
# frames) request three times under share_prefix: two prefill reuses.
SF_SLOTS = 3
STATE_FAMILIES = {
    "X": dict(arch="xlstm-350m", prompt=1024, max_len=1088,
              modes=("clean", "0.98", "dense_write", "ecc_write"),
              sched_prompts=(128, 1024, 384, 640, 256, 896),
              sched_new=(8, 24, 16, 12, 20, 10), shared=(),
              trace_prompt=256),
    # 448: whisper's text context
    "W": dict(arch="whisper-large-v3", prompt=64, max_len=448,
              modes=("clean", "0.98", "dense_write", "ecc_write"),
              sched_prompts=(64, 96, 64, 128, 64, 32),
              sched_new=(8, 12, 8, 6, 8, 10), shared=(0, 2, 4),
              trace_prompt=64),
    "V": dict(arch="internvl2-2b", prompt=512, max_len=1024,
              modes=("clean", "dense_write"),
              sched_prompts=(64, 512, 192, 384, 128, 320),
              sched_new=(8, 24, 16, 12, 20, 10), shared=(),
              trace_prompt=128),
}
# the reduced float32 train step, card vs CPU: |card - cpu| <= this
# times (1 + |cpu|)
SF_TRAIN_TOL = 1e-5


def sf_plan(key):
    """(plan, kv_injection) of a generate() mode of the state families."""
    return {"clean": (None, "auto"), "0.98": (plan_at(0.98), "auto"),
            "dense_write": (plan_at(V_DENSE), "write"),
            "ecc_write": (plan_at(V_DENSE_ECC, True), "write")}[key]


def sf_extras(cfg, batch=None, seed=0, dev=None):
    """The family's modality inputs from a seed: batched on ``dev`` for
    generate(), unbatched numpy (as a request carries them) otherwise."""
    import numpy as np
    import torch
    shape = ((cfg.enc_len, cfg.d_model) if cfg.family == "audio" else
             (cfg.enc_len, cfg.frontend_dim) if cfg.family == "vlm"
             else None)
    if shape is None:
        return {}
    key = "frames" if cfg.family == "audio" else "patches"
    if batch is None:
        return {key: np.random.RandomState(seed).standard_normal(
            shape).astype(np.float32)}
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {key: torch.randn((batch,) + shape, generator=gen, device=dev)}


class CheckedArena(ArenaRecorder):
    """Holds every K1 / K2 call made inside against its plain version on
    the same words as the call returns; ``checked`` lists the words each
    call changed."""

    def __init__(self, label):
        super().__init__()
        self.label = label
        self.checked = []

    def _wrap(self, name, fn):
        def run(arena, block_base, block_thr, **kw):
            out = fn(arena, block_base, block_thr, **kw)
            self.checked.append(check_arena_call(
                f"{self.label} {name}",
                (name, arena, block_base, block_thr, kw, out)))
            return out
        return run


def sf_serve(bundle, cfg, params, dev, sc, reqs, capture):
    """The state-arena scheduler over ``reqs``; returns (scheduler,
    results, wall seconds, launches)."""
    from repro_torch.kernels import _build
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request)
    from repro_torch.serving.statearena import StateArenaScheduler
    sched = ContinuousBatchingScheduler(bundle, cfg, params, sc,
                                        num_slots=SF_SLOTS, device=dev,
                                        capture=capture)
    if not isinstance(sched, StateArenaScheduler):
        raise AssertionError(f"{cfg.arch_id}: the front door did not give "
                             "the state arena")
    for rid, t, n, ex in reqs:
        sched.submit(Request(rid=rid, tokens=t, max_new_tokens=n,
                             extras=ex))
    before = _build.launch_counts()
    t0 = time.perf_counter()
    res = sched.run()
    wall = time.perf_counter() - t0
    after = _build.launch_counts()
    return sched, res, wall, {k: after[k] - before.get(k, 0) for k in after
                              if after[k] - before.get(k, 0)}


def cross_reinjection_ms(bundle, cfg, cache, max_len, pos):
    """Device ms of the per-step write path over generate()'s 0.88 V
    cache: whole, and over whisper's cross leaves alone (its other leaves
    skipped), each pass re-masking words that already carry their faults
    (idempotent)."""
    import torch
    from repro_torch.core import engine as arena
    from repro_torch.core import pytree
    from repro_torch.models.base import (cache_layouts, cache_slot_axes,
                                         spec_avals)
    specs = bundle.module.cache_specs(cfg, ZOO_B, max_len)
    plan = plan_at(V_DENSE)
    plc = plan.place({"kv_cache": spec_avals(specs)})["kv_cache"]
    fmap = plan.fault_map()
    method = arena.resolve_method(fmap, plc, V_DENSE)
    axes = cache_slot_axes(specs)
    lay = {pytree.keystr(p): k for p, k in pytree.flatten_with_path(
        cache_layouts(specs, max_len))}
    other = tuple(p for p, k in lay.items() if k != "cross")
    p = torch.full((ZOO_B,), pos, dtype=torch.int32,
                   device=_leaves(cache)[0].device)

    def run(skip):
        return lambda: arena.inject_placement_slice(
            cache, plc, fmap, slot_axes=axes, pos=p, voltage=V_DENSE,
            method=method, skip_paths=skip)

    cross_words = sum(int(t.numel() * t.element_size() // 4)
                      for path, t in pytree.flatten_with_path(cache)
                      if lay[pytree.keystr(path)] == "cross")
    return dict(method=method, cross_words=cross_words,
                write_path_ms=cuda_ms(run(()), reps=3),
                cross_ms=cuda_ms(run(other), reps=3))


def state_family_phase(dev, key):
    """X, W or V at full width (bf16, weights from a seeded generator):
    generate() with batch 4 in each of the family's modes (0.98 V ==
    clean; the 0.88 V write request served again with every decode step
    eager == captured on tokens, cache words and launches; one captured
    decode step traced), then the state-arena scheduler (3 slots, 6
    requests at 0.88 V write, each with its extras): each request == its
    solo generate(kv_placement=) replay on bits, decode_traces 1, the
    same traffic with every step eager == captured on tokens, cache words
    and launches.  W: three of the requests repeat one (tokens, frames)
    under share_prefix (prefill_reuse 2, equal tokens), and the cross
    leaves' per-step re-injection is timed.  Every K1 / K2 launch == its
    plain version on the same words."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import ServeConfig, generate
    spec = STATE_FAMILIES[key]
    bundle, cfg, params = zoo_model(dev, spec["arch"])
    name = cfg.arch_id
    gen = torch.Generator(device=dev).manual_seed(26)
    prompts = torch.randint(0, cfg.vocab, (ZOO_B, spec["prompt"]),
                            generator=gen, device=dev)
    extras = sf_extras(cfg, ZOO_B, 27, dev)
    max_len = spec["max_len"]
    phases, toks = {}, {}
    _build.reset_launch_counts()
    check = CheckedArena(name)
    with check:
        for mode in spec["modes"]:
            plan, inj = sf_plan(mode)
            n0 = len(check.checked)
            toks[mode], phases[mode] = zoo_generate(
                bundle, cfg, params, dev, prompts, max_len, plan, inj,
                f"{name} generate[{mode}]", keep_cache=mode == "dense_write",
                extras=extras)
            phases[mode]["k1k2_words_changed"] = check.checked[n0:]
        if "0.98" in toks and not torch.equal(toks["0.98"], toks["clean"]):
            raise AssertionError(f"{name} generate: 0.98 V tokens != clean")
        if not sum(phases["dense_write"]["k1k2_words_changed"]):
            raise AssertionError(f"{name} generate: K1 at {V_DENSE} V "
                                 "changed no word")
        n0 = len(check.checked)
        etoks, eager = zoo_generate(
            bundle, cfg, params, dev, prompts, max_len, *sf_plan(
                "dense_write"), f"{name} generate[dense_write]",
            capture=False, keep_cache=True, extras=extras)
        cap = phases["dense_write"]
        ecache = eager.pop("cache")
        if not torch.equal(etoks, toks["dense_write"]):
            raise AssertionError(f"{name} generate: captured tokens != eager")
        if not tree_bits_equal(cap["cache"], ecache):
            raise AssertionError(f"{name} generate: captured cache words != "
                                 "eager")
        if cap["launches"] != eager["launches"]:
            raise AssertionError(f"{name} generate: captured launches "
                                 f"{cap['launches']} != eager "
                                 f"{eager['launches']}")
        del ecache
        phases["captured_vs_eager"] = dict(
            captured_ms_per_token=cap["steady_ms_per_token"],
            eager_ms_per_token=eager["steady_ms_per_token"])
        phases["agree_write_vs_clean"] = float(
            (toks["dense_write"] == toks["clean"]).float().mean())
        cache = cap.pop("cache")
        if cfg.family == "audio":
            cross = cross_reinjection_ms(bundle, cfg, cache, max_len,
                                         spec["prompt"] + ZOO_NEW - 1)
            cross["share_of_captured_step"] = (
                cross["cross_ms"] / cap["steady_ms_per_token"])
            phases["cross_reinjection"] = cross
            log(f"{name}: the per-step write path over the 0.88 V cache "
                f"({cross['method']}) takes {cross['write_path_ms']:.3f} ms, "
                f"the cross leaves ({cross['cross_words'] / 1e6:.1f} M "
                f"words) {cross['cross_ms']:.3f} ms of it: "
                f"{cross['share_of_captured_step']:.3f} of the captured step "
                f"({cap['steady_ms_per_token']:.3f} ms)")
        del cache
        torch.cuda.empty_cache()
        log(f"{name} generate: 0.98 V == clean, captured == eager at "
            f"{V_DENSE} V write (tokens, cache words, launches); write tokens "
            f"equal to clean: {phases['agree_write_vs_clean']:.3f}")

        reqs = []
        for i, (p, n) in enumerate(zip(spec["sched_prompts"],
                                       spec["sched_new"])):
            src = spec["shared"][0] if i in spec["shared"] else i
            reqs.append((f"{key.lower()}{i}",
                         np.random.RandomState(100 + src).randint(
                             0, cfg.vocab, (p,)).astype(np.int64), n,
                         sf_extras(cfg, seed=200 + src) or None))
        sc = ServeConfig(max_len=max_len, max_new_tokens=8,
                         undervolt=plan_at(V_DENSE), kv_injection="write",
                         share_prefix=bool(spec["shared"]))
        esched, eres, _, elaunch = sf_serve(bundle, cfg, params, dev, sc,
                                            reqs, False)
        eager_ms = steady_ms(esched.step_seconds["decode"])
        ecache = esched.state["cache"]
        del esched
        sched, res, wall, launches = sf_serve(bundle, cfg, params, dev, sc,
                                              reqs, True)
        st = sched.stats
        if st["decode_traces"] != 1:
            raise AssertionError(f"{name} sched: decode_traces "
                                 f"{st['decode_traces']}")
        if (any(not np.array_equal(res[r].tokens, eres[r].tokens)
                for r, *_ in reqs) or launches != elaunch
                or not tree_bits_equal(sched.state["cache"], ecache)):
            raise AssertionError(f"{name} sched: captured != eager (tokens, "
                                 "cache words or launches)")
        del ecache
        if spec["shared"]:
            first = reqs[spec["shared"][0]][0]
            if st["prefill_reuse"] != len(spec["shared"]) - 1 or any(
                    not np.array_equal(res[reqs[i][0]].tokens,
                                       res[first].tokens)
                    for i in spec["shared"]):
                raise AssertionError(f"{name} sched: prefill_reuse "
                                     f"{st['prefill_reuse']}, or the repeated "
                                     "requests' tokens differ")
        for rid, t, n, ex in reqs:
            batch = {"tokens": torch.from_numpy(t)[None]}
            for k, v in (ex or {}).items():
                batch[k] = torch.from_numpy(v)[None]
            ref = generate(bundle, cfg, params, batch,
                           dataclasses.replace(sc, max_new_tokens=n),
                           device=dev, kv_placement=res[rid].placement)
            if not np.array_equal(ref.cpu().numpy(), res[rid].tokens):
                raise AssertionError(f"{name} sched request {rid}: served "
                                     "tokens != its solo replay")
    dec = sched.step_seconds["decode"]
    n_tok = sum(res[r].tokens.shape[1] for r, *_ in reqs)
    phases["sched"] = dict(
        steps=sched.steps, step_steady_ms=steady_ms(dec),
        eager_step_steady_ms=eager_ms, wall_s=wall, tokens=n_tok,
        tokens_per_s=n_tok / wall, peak_active=sched.peak_active,
        prefill_reuse=st["prefill_reuse"], launches=launches)
    log(f"{name} sched (state arena, {SF_SLOTS} slots, {len(reqs)} requests, "
        f"{V_DENSE} V write): {sched.steps} steps, steady "
        f"{phases['sched']['step_steady_ms']:.3f} ms (eager {eager_ms:.3f}), "
        f"decode_traces 1, prefill_reuse {st['prefill_reuse']}, "
        f"{n_tok / wall:.1f} tokens/s (admissions included); captured == "
        "eager (tokens, cache words, launches); every request == its solo "
        f"generate(kv_placement=...) replay; launches {launches}")
    counts = _build.launch_counts()
    k12 = sum(counts.get(k, 0) for k in ("arena_bitflip", "arena_ecc"))
    if len(check.checked) != k12 or k12 == 0:
        raise AssertionError(f"{name}: {len(check.checked)} K1/K2 calls "
                             f"checked, {k12} launched")
    phases["k1k2_checked"] = len(check.checked)
    log(f"{name}: every one of its {k12} K1/K2 launches == its plain "
        f"version on the same words ({counts})")
    del sched, res
    tsc = ServeConfig(max_len=max_len, max_new_tokens=TRACE_NEW,
                      undervolt=plan_at(V_DENSE), kv_injection="write")
    tp = spec["trace_prompt"]
    phases["trace"] = trace_decode_steps(
        f"{key}_generate_captured", lambda: generate(
            bundle, cfg, params, {"tokens": prompts[:, :tp], **extras}, tsc,
            device=dev))
    del params
    torch.cuda.empty_cache()
    return counts, phases


def state_family_small_checks(dev):
    """The three families' reduced configs in float32: greedy tokens on
    the card (K1 / K2 on the write path) equal the CPU's (plain versions)
    clean, at 0.86 V write and at 0.875 V ECC write; one train step's loss
    on the card within SF_TRAIN_TOL (1 + |CPU|) of the CPU's, and the loss
    after it within TRAIN_LOSS_RTOL."""
    import numpy as np
    import torch
    from repro_torch.core import pytree
    from repro_torch.core.domains import MemoryDomain
    from repro_torch.core.hbm import VCU128
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models.base import get_arch, init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.training import trainer
    from repro_torch.training.undervolt import UndervoltPlan
    out = {}
    for key, spec in STATE_FAMILIES.items():
        bundle = get_arch(spec["arch"])
        cfg = dataclasses.replace(bundle.reduced, dtype=torch.float32)
        params = init_params(bundle.module.param_specs(cfg),
                             torch.Generator().manual_seed(0), device="cpu")
        params_dev = pytree.tree_map(lambda t: t.to(dev), params)
        batch = {"tokens": np.random.RandomState(3).randint(
            0, cfg.vocab, (2, 9))}
        batch.update({k: np.stack([v, v[::-1]]) for k, v in sf_extras(
            cfg, seed=4).items()})
        for v, ecc in ((None, False), (0.86, False), (0.875, True)):
            plan = None if v is None else UndervoltPlan(
                domains={"kv": MemoryDomain("kv", v, tuple(range(32)),
                                            ecc=ecc)},
                policy={"kv_cache": "kv"}, geometry=VCU128)
            sc = ServeConfig(max_len=40, max_new_tokens=8, undervolt=plan,
                             kv_injection="write")
            cpu = generate(bundle, cfg, params, batch, sc, device="cpu")
            gpu = generate(bundle, cfg, params_dev, batch, sc,
                           device=dev).cpu()
            if not torch.equal(cpu, gpu):
                raise AssertionError(f"reduced {cfg.arch_id} f32 {v} V "
                                     f"ecc={ecc}: card tokens {gpu.tolist()} "
                                     f"!= CPU {cpu.tolist()}")
        # xLSTM's sequence crosses an mLSTM chunk
        dc = DataConfig(vocab=cfg.vocab, seq_len=140 if key == "X" else 24,
                        global_batch=2, seed=5)
        init = trainer.init_state(bundle, cfg,
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
        tc = trainer.TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=2,
                                                   total_steps=50))

        def run(device):
            state = state_to(init, device)
            step = trainer.make_train_step(bundle, cfg, tc)
            state, m = step(state, trainer.device_batch(
                make_batch(dc, 0, cfg), device))
            with torch.no_grad():
                after, _ = bundle.module.forward_train(
                    state["params"], trainer.device_batch(
                        make_batch(dc, 1, cfg), device), cfg)
            return float(m["loss"]), float(after)

        cpu, card = run(torch.device("cpu")), run(dev)
        if abs(card[0] - cpu[0]) > SF_TRAIN_TOL * (1 + abs(cpu[0])):
            raise AssertionError(f"reduced {cfg.arch_id} f32 train step: card "
                                 f"loss {card[0]} != CPU {cpu[0]}")
        after_rel = losses_agree(f"reduced {cfg.arch_id} after one step",
                                 [card[1]], [cpu[1]])
        out[key] = dict(card_losses=card, cpu_losses=cpu,
                        step_abs_err=abs(card[0] - cpu[0]),
                        after_rel=after_rel)
        log(f"small input: reduced {cfg.arch_id} f32 greedy tokens equal on "
            "card and CPU (clean, 0.86 V write, 0.875 V ECC write); train "
            f"step loss card {card[0]!r} vs CPU {cpu[0]!r}, after it "
            f"{card[1]!r} vs {cpu[1]!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--phases", default="all",
                    help="'all' (the default: every phase, and the kernels "
                    "line), or a comma list of groups to run alone: base "
                    "(every phase before the model zoo but T2), T2, zoo "
                    "(G, Y, M, the exporters, the state families' small "
                    "checks and X, W, V), or of the zoo's state families "
                    "X, W, V alone (with their small checks)")
    args = ap.parse_args(argv)
    groups = set(args.phases.split(","))
    full = "all" in groups
    if not full and not groups <= {"base", "T2", "zoo", "X", "W", "V"}:
        ap.error(f"unknown phase groups {sorted(groups)}")
    families = [k for k in STATE_FAMILIES
                if full or "zoo" in groups or k in groups]
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    # T2 and T3 run under deterministic algorithms, which need cuBLAS's
    # workspace fixed before its first handle is made.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    ops_per_word = dict(OPS_PER_WORD)
    sass = sass_per_word()
    for method, n in sass.items():
        ops_per_word[method] = n["alu"]
    report = {"card": card, "build_s": build_s, "sass_per_word": sass,
              "ops_per_word": ops_per_word}
    seconds = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return out

    counts, rows = {}, []
    if full or "base" in groups:
        t = time.perf_counter()
        argmax_nan_check(dev)
        row_report = row_invariance_check(dev)
        rows = kernel_phases(dev, ops_per_word)
        rows.append(paged_kernel_phase(dev, ops_per_word))
        rows.extend(segment_kernel_phase(dev, ops_per_word))
        sweep_row, k5_sweep = sweep_phase(dev)
        seg_report, seg_launches = segments_phase(dev)
        rows.extend(hybrid_kernel_phase(dev))
        small_input_check(dev)
        heal_small = heal_reduced_phase(dev)
        hyb_small_err = hybrid_small_input_check(dev)
        t1 = timed("T1", train_quickstart_phase, dev)
        t3 = timed("T3", train_checkpoint_governor_phase, dev)
        t4 = timed("T4", train_hybrid_phase, dev)
        seconds["kernels_sweep_reduced"] = time.perf_counter() - t
        t = time.perf_counter()
        bundle, cfg, params = full_width_model(dev)
        counts, phases, agree = serving_phases(dev, bundle, cfg, params)
        governor_row = governor_phase(dev, bundle, cfg, params)
        k4_launches, sched_phases, sched_agree = scheduler_phases(
            dev, bundle, cfg, params)
        heal_report, heal_row, heal_launches = heal_full_width_phase(
            dev, bundle, cfg, params, ops_per_word)
        rows.append(heal_row)
        sched_gov = sched_governor_phase(dev, bundle, cfg, params)
        del params
        torch.cuda.empty_cache()
        seconds["llama_serving"] = time.perf_counter() - t
        counts["arena_bitflip"] += t1["launches"]["arena_bitflip"]
        counts["paged_decode"] = k4_launches
        counts["arena_ecc_events"] = heal_launches["arena_ecc_events"]
        counts["segment_bitflip"] = k5_sweep + seg_launches["segment_bitflip"]
        counts["segment_ecc"] = seg_launches["segment_ecc"]
        report.update(
            kernels=rows, serving=phases, token_agreement=agree,
            scheduler=sched_phases, scheduler_agreement=sched_agree,
            sweep=sweep_row, segments=seg_report, governor=governor_row,
            row_invariance=row_report,
            selfheal={"reduced": heal_small, "full_width": heal_report,
                      "scheduler_governor": sched_gov},
            hybrid_small_logit_err=hyb_small_err,
            training={"T1": t1, "T3": t3, "T4": t4})
    if full or "T2" in groups:
        t2, t2_launches = timed("T2", train_full_width_phase, dev,
                                      ops_per_word)
        torch.cuda.empty_cache()
        report.setdefault("training", {})["T2"] = t2
        for name in ("arena_bitflip", "arena_ecc"):
            counts[name] = counts.get(name, 0) + t2_launches[name]
    if full or "base" in groups:
        t = time.perf_counter()
        bundle, cfg, params = hybrid_model(dev)
        hyb_counts, hyb_phases, hyb_differ = hybrid_serving_phases(
            dev, bundle, cfg, params)
        hyb_sched_counts, hyb_sched_phases = hybrid_scheduler_phases(
            dev, bundle, cfg, params)
        del params
        torch.cuda.empty_cache()
        seconds["recurrentgemma_serving"] = time.perf_counter() - t
        for name in set(hyb_counts) | set(hyb_sched_counts):
            if name.startswith(("flash_prefill", "rglru_scan")):
                counts[name] = (hyb_counts.get(name, 0)
                                + hyb_sched_counts.get(name, 0))
        report.update(hybrid_serving=hyb_phases,
                      hybrid_token_differ_from_nofault=hyb_differ,
                      hybrid_scheduler=hyb_sched_phases)
    if full or "zoo" in groups:
        zoo = report["zoo"] = {}
        zoo["head_shapes"] = timed("Y_heads", zoo_head_shape_phase, dev,
                                   ops_per_word)
        t = time.perf_counter()
        bundle, cfg, params = zoo_model(dev, "gemma3-4b")
        g_counts, zoo["gemma3_generate"] = timed(
            "G_generate", gemma_phases, dev, bundle, cfg, params)
        g_sched_counts, zoo["gemma3_scheduler"], sched = timed(
            "G_scheduler", gemma_scheduler_phase, dev, bundle, cfg, params)
        zoo["obs"] = obs_phase(sched)
        del sched, params
        torch.cuda.empty_cache()
        seconds["G"] = time.perf_counter() - t
        y_counts, zoo["llama3_8b"] = timed("Y_llama3_8b", dense_zoo_phase,
                                           dev)
        m_counts, zoo["deepseek"] = timed("M", moe_phases, dev)
        t_counts, zoo["deepseek_tiering"] = timed("M_tiering",
                                                  moe_tiering_phase, dev)
        for c in (g_counts, g_sched_counts, y_counts, m_counts, t_counts):
            for name, n in c.items():
                counts[name] = counts.get(name, 0) + n
        by_shape = zoo["head_shapes"]
        for row in rows:
            for key, r in by_shape.items():
                if row["name"] == "faulty_decode_attention":
                    row["variants"][f"read_word_{key}"] = dict(
                        ms=r["k3_ms"], max_abs_err=r["k3_max_abs_err"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["sdpa_ms"], inject_off_ms=r[
                            "k3_off_ms"], tile=r["k3_tile"])
                elif row["name"] == "paged_decode_attention":
                    row["variants"][f"read_word_{key}"] = dict(
                        ms=r["k4_ms"], max_abs_err=r["k4_max_abs_err"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                        library_ms=r["sdpa_ms"], inject_off_ms=r[
                            "k4_off_ms"], splits=r["k4_splits"])
    if families:
        zoo = report.setdefault("zoo", {})
        zoo["state_small"] = timed("XWV_small", state_family_small_checks,
                                   dev)
        for key in families:
            c, zoo[STATE_FAMILIES[key]["arch"]] = timed(
                key, state_family_phase, dev, key)
            for name, n in c.items():
                counts[name] = counts.get(name, 0) + n
    report["phase_seconds"] = seconds
    log(f"phase seconds: {json.dumps(seconds)}")
    if full:
        by_lib = {"arena_bitflip": "arena_bitflip", "arena_ecc": "arena_ecc",
                  "ecc_page_events": "arena_ecc_events",
                  "faulty_decode_attention": "faulty_decode",
                  "paged_decode_attention": "paged_decode",
                  "bitflip": "segment_bitflip", "segment_ecc": "segment_ecc",
                  "flash_attention": "flash_prefill",
                  "rglru_scan": "rglru_scan"}
        for row in rows:
            lib = by_lib[row["name"]]
            row["launches"] = counts[lib]
            by_variant = {key[len(lib) + 1:]: n for key, n in counts.items()
                          if key.startswith(lib + "/")}
            if by_variant:
                row["launches_by_variant"] = by_variant
            if row["launches"] <= 0:
                raise AssertionError(f"kernel {row['name']} was not launched "
                                     "on its main path")
    report["total_s"] = time.perf_counter() - t_start
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1, default=str))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "host_ms", "variant", "launches_by_variant",
            "variants")
    log(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    if full:
        print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                      for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
