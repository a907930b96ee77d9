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
     the uninjected one) and read-path injection against attention over
     the write-path-corrupted cache (bits equal); each timed with CUDA
     events beside its bound;
  2. a small-input check: reduced llama3.2-3b in float32 serves the same
     greedy tokens on the card (kernels) and on the CPU (plain versions);
  3. serving phases through ``generate()``: full-width llama3.2-3b (28
     layers, bf16, weights from a seeded generator): clean, 0.98 V (must
     equal clean), 0.91 V read vs write and 0.91 V with ECC read vs write
     (must be equal; the timed phases), 0.975 V (the K3 route with no
     fault), 0.88 V read vs write, 0.875 V with ECC read vs write
     and 0.8775 V with ECC read vs write (each pair equal, and unlike the
     0.975 V tokens), with the kernels' launch counts.

Any mismatch raises; nothing is caught.  The last three lines are the
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
MIN_FINITE_SHARE = 0.5


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, int_ops: float = 0.0, flops: float = 0.0):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = int_ops / INT_OPS_PER_S + flops / F32_FLOPS_PER_S
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
    """K3 against its plain version: the same NaN and infinity pattern, and
    |got - ref| <= K3_ATOL + K3_RTOL * |ref| on every finite entry.
    Returns the largest absolute error over the finite entries."""
    import torch
    a, b = got.float(), ref.float()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise AssertionError(f"K3 {label}: kernel and plain version differ "
                             "in NaN pattern")
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(a[~fin].nan_to_num(0.0), b[~fin].nan_to_num(0.0)):
        raise AssertionError(f"K3 {label}: kernel and plain version differ "
                             "in infinities")
    diff = (a[fin] - b[fin]).abs()
    over = diff > K3_ATOL + K3_RTOL * b[fin].abs()
    if bool(over.any()):
        raise AssertionError(
            f"K3 {label}: {int(over.sum())} finite outputs outside "
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
        ms = cuda_ms(lambda: bitflip.arena_bitflip(
            arena, base_m, thr_m, method=method, **kw), reps=10)
        plain_ms = cuda_ms(lambda: bitflip.arena_bitflip_ref(
            arena, base_m, thr_m, method=method, **kw), reps=1, warmup=0)
        b_ms, b_by = bound(8 * words + table_bytes,
                           int_ops=words * ops_per_word[method])
        variants[method] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                words_changed=changed, voltage=v)
        log(f"K1 arena_bitflip[{method}] {nb} blocks @ {v} V: bit-equal to "
            f"plain, {changed} words changed; {ms:.4f} ms (bound {b_ms:.4f} "
            f"ms by {b_by}; plain {plain_ms:.2f} ms)")
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
                 reps=10)
    plain_ms = cuda_ms(lambda: ecc_mod.arena_ecc_ref(arena, base_e, thr_e,
                                                     **kw), reps=1, warmup=0)
    b_ms, b_by = bound(8 * words + table_bytes + 8 * nb,
                       int_ops=words * ops_per_word["ecc"])
    rows.append(dict(name="arena_ecc", route="cuda",
                     source="src/repro_torch/kernels/csrc/arena_ecc.cu",
                     replaces="src/repro/kernels/ecc/ecc.py:105",
                     max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=None, variants={},
                     corrected=n_corr, uncorrectable=n_bad,
                     words_changed=changed, voltage=V_DENSE_ECC))
    log(f"K2 arena_ecc {nb} blocks @ {V_DENSE_ECC} V: bits and counts equal "
        f"({n_corr} corrected, {n_bad} uncorrectable, {changed} words "
        f"changed); {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; plain "
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
        err = k3_compare(label, got, ref)
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
        ms = cuda_ms(lambda: [attend(c, i, k_leaf[i], v_leaf[i])
                              for i in range(n_layers)], reps=3) / n_layers
        plain_ms = cuda_ms(lambda: attend(
            c, layer, k_leaf[layer], v_leaf[layer],
            which=faulty.faulty_decode_attention_ref), reps=1, warmup=0)
        n_ops = (kv_words * (ops_per_word["ecc" if ecc else method]
                             + K3_ADDR_OPS) if inject else 0)
        b_ms, b_by = bound(io_bytes, int_ops=n_ops, flops=attn_flops)
        k3[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, voltage=v, **extra)
        log(f"K3 faulty_decode_attention[{label}] (B={B}, L={L}, KH={KH}, "
            f"G={H // KH}, D={D}) @ {v} V: max abs err {err:.3g} vs plain "
            f"(finite outputs); {ms * 1e3:.2f} us/layer (bound "
            f"{b_ms * 1e3:.2f} us by {b_by}; plain {plain_ms:.2f} ms)")

    # SDPA yardstick for K3 without injection (the port never calls it)
    import torch.nn.functional as F
    qt = q.transpose(1, 2).contiguous()
    kt = k_leaf.permute(0, 1, 3, 2, 4).contiguous()
    vt = v_leaf.permute(0, 1, 3, 2, 4).contiguous()
    sdpa_ms = cuda_ms(lambda: [F.scaled_dot_product_attention(
        qt, kt[i], vt[i], enable_gqa=True) for i in range(n_layers)],
        reps=3) / n_layers
    k3["inject_off"]["library_ms"] = sdpa_ms
    log(f"SDPA yardstick (no injection, enable_gqa): {sdpa_ms * 1e3:.2f} "
        "us/layer")
    main = k3.pop("read_word")
    rows.append(dict(name="faulty_decode_attention", route="cuda",
                     source="src/repro_torch/kernels/csrc/faulty_decode.cu",
                     replaces="src/repro/kernels/flash_attention/faulty.py:238",
                     library_ms=None, **main, variants=k3))
    del k_leaf, v_leaf, kt, vt
    torch.cuda.empty_cache()
    return rows


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


def serving_phases(dev):
    """The main path: generate() at full width, with launch counts."""
    import torch
    from repro_torch.core import pytree
    from repro_torch.kernels import _build
    from repro_torch.models.base import get_arch, init_params
    from repro_torch.serving.engine import ServeConfig, generate

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
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))

    def run(label, plan, mode="auto"):
        sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW, undervolt=plan,
                         kv_injection=mode)
        before = _build.launch_counts()
        timings = {}
        toks = generate(bundle, cfg, params, {"tokens": prompts}, sc,
                        device=dev, timings=timings)
        after = _build.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
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
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    log(f"main-path launches: {counts}")
    del params
    torch.cuda.empty_cache()
    return counts, phases, agree


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
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {len(_build.KERNELS)} kernels (parallel nvcc, sm_90a) in "
        f"{build_s:.1f} s")

    argmax_nan_check(dev)
    ops_per_word = dict(OPS_PER_WORD)
    sass = sass_per_word()
    for method, n in sass.items():
        ops_per_word[method] = n["alu"]
    rows = kernel_phases(dev, ops_per_word)
    small_input_check(dev)
    counts, phases, agree = serving_phases(dev)
    by_lib = {"arena_bitflip": "arena_bitflip", "arena_ecc": "arena_ecc",
              "faulty_decode_attention": "faulty_decode"}
    for row in rows:
        row["launches"] = counts[by_lib[row["name"]]]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "kernels": rows,
             "serving": phases, "token_agreement": agree,
             "sass_per_word": sass, "ops_per_word": ops_per_word},
            indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "variants")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
