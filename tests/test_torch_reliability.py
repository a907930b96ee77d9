"""The port's per-segment injectors (K5, K6), the segments engine and the
paper's Algorithm 1 tester held against the JAX reference, bit for bit.

K5's and K6's plain versions against the reference's ``inject_u32`` /
``inject_and_correct_u32`` (interpret-mode Pallas; its jnp oracle for
bitwise runs longer than one block, which the reference's own tests hold
equal to the kernel), both ECC tail-count routes, a run that wraps past
physical word 2**32, the three-way equality of the reference's
``tests/test_engine.py`` (port segments == port arena == the reference),
and ``run_pc_test`` / ``sweep`` counts.  ``cuda``-marked tests hold the
CUDA kernels against their plain versions and K5 against K1 on the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import injection as jinjection
from repro.core import reliability as jrel
from repro.core.domains import MemoryDomain as JDomain
from repro.core.domains import place_groups as jplace
from repro.core.faultmap import PAPER_MAP_SEED
from repro.core.faultmap import FaultMap as JFaultMap
from repro.core.hbm import VCU128 as JVCU128
from repro.core.hbm import HBMGeometry as JGeometry
from repro.kernels.bitflip import ops as jops
from repro.kernels.ecc import ops as jecc_ops

from repro_torch import convert
from repro_torch.core import hashing, injection, reliability
from repro_torch.core.domains import MemoryDomain, place_groups
from repro_torch.core.faultmap import FaultMap
from repro_torch.core.hbm import VCU128, HBMGeometry
from repro_torch.kernels import _build
from repro_torch.kernels.bitflip import bitflip
from repro_torch.kernels.bitflip import ops as tops
from repro_torch.kernels.ecc import ecc
from repro_torch.kernels.ecc import ops as tecc_ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


JMAP = JFaultMap.from_seed(JVCU128, seed=PAPER_MAP_SEED)
TMAP = FaultMap.from_seed(VCU128, seed=PAPER_MAP_SEED)
PC_WORDS = VCU128.bytes_per_pc // 4
# (voltage, PC): a sparse word-path point, the paper's hot PC at 0.88 V,
# and a point near saturation where most words change.
POINTS = [(0.91, 18), (0.88, 19), (0.86, 3)]
INTERPRET_BITWISE_WORDS = 4096


def _words(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


def _t(words):
    return torch.from_numpy(words.view(np.int32).copy())


def _u32(t):
    return t.numpy().view(np.uint32)


def _jax_inject(words, v, pc, base, method):
    return np.asarray(jops.inject_u32(
        jnp.asarray(words), thresholds=JMAP.thresholds(v, pc),
        seed=JMAP.seed, base_word=base, method=method,
        use_ref=method == "bitwise" and words.size > INTERPRET_BITWISE_WORDS))


@pytest.mark.parametrize("v,pc", POINTS)
@pytest.mark.parametrize("n", [4096, 8192, 100, 70000])
def test_segment_kernels_match_reference(n, v, pc):
    """K5 (word, bitwise) and K6 through the port's ops == the reference's
    ops on bits and uncorrectable counts."""
    words = _words(n, n)
    base = pc * PC_WORDS + 3 * 4096
    thr = TMAP.thresholds(v, pc)
    for method in ("word", "bitwise"):
        got = tops.inject_u32(_t(words), thresholds=thr, seed=TMAP.seed,
                              base_word=base, method=method)
        np.testing.assert_array_equal(
            _u32(got), _jax_inject(words, v, pc, base, method),
            err_msg=method)
    out, bad = tecc_ops.inject_and_correct_u32(
        _t(words), thresholds=thr, seed=TMAP.seed, base_word=base)
    jout, jbad = jecc_ops.inject_and_correct_u32(
        jnp.asarray(words), thresholds=JMAP.thresholds(v, pc),
        seed=JMAP.seed, base_word=base)
    np.testing.assert_array_equal(_u32(out), np.asarray(jout))
    assert int(bad) == int(jbad)
    if v <= 0.86:
        assert (_u32(got) != words).any() and int(bad) > 0


def test_ecc_tail_counts_follow_each_route():
    """On an unaligned run the default route counts the uncorrectable
    codewords of the zero-padded tail (as the reference's kernel route),
    ``use_ref`` only those of the run padded to even (as its oracle)."""
    v, pc, n = 0.86, 3, 101
    words = _words(n, 5)
    base = pc * PC_WORDS
    thr, jthr = TMAP.thresholds(v, pc), JMAP.thresholds(v, pc)
    counts = {}
    for use_ref in (False, True):
        out, bad = tecc_ops.inject_and_correct_u32(
            _t(words), thresholds=thr, seed=TMAP.seed, base_word=base,
            use_ref=use_ref)
        jout, jbad = jecc_ops.inject_and_correct_u32(
            jnp.asarray(words), thresholds=jthr, seed=JMAP.seed,
            base_word=base, use_ref=use_ref)
        np.testing.assert_array_equal(_u32(out), np.asarray(jout))
        assert int(bad) == int(jbad)
        counts[use_ref] = int(bad)
    # the padded tail of the one 4096-word block holds most of the count
    assert counts[False] > counts[True] > 0
    per_block = ecc.segment_ecc(_t(words), thresholds=thr, seed=TMAP.seed,
                                base_word=base)[1]
    assert per_block.shape == (1,) and int(per_block[0]) == counts[False]


def test_run_wrapping_past_word_2_32_matches_reference():
    """Physical word ids are uint32: a run that starts near 2**32 wraps to
    word 0 in both packages (K5 word and bitwise, K6)."""
    n, v, pc = 3 * 4096 + 6, 0.86, 3
    base = 2 ** 32 - 2 * 4096 - 7
    words = _words(n, 9)
    thr = TMAP.thresholds(v, pc)
    for method in ("word", "bitwise"):
        got = tops.inject_u32(_t(words), thresholds=thr, seed=TMAP.seed,
                              base_word=base, method=method)
        np.testing.assert_array_equal(
            _u32(got), _jax_inject(words, v, pc, base, method))
    out, bad = tecc_ops.inject_and_correct_u32(
        _t(words), thresholds=thr, seed=TMAP.seed, base_word=base)
    jout, jbad = jecc_ops.inject_and_correct_u32(
        jnp.asarray(words), thresholds=JMAP.thresholds(v, pc),
        seed=JMAP.seed, base_word=base)
    np.testing.assert_array_equal(_u32(out), np.asarray(jout))
    assert int(bad) == int(jbad) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_inject_any_dtype_matches_reference(dtype):
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 1001).astype(np.float32).astype(jnp.bfloat16)
         if dtype == "bfloat16" else
         rng.randint(-100, 100, 5003).astype(np.int8) if dtype == "int8"
         else rng.randn(2, 777).astype(np.float32))
    v, pc = 0.86, 3
    ref = jops.inject(jnp.asarray(x), thresholds=JMAP.thresholds(v, pc),
                      seed=JMAP.seed, base_word=pc * PC_WORDS, method="word")
    got = tops.inject(convert.cache_from_jax(x),
                      thresholds=TMAP.thresholds(v, pc), seed=TMAP.seed,
                      base_word=pc * PC_WORDS, method="word")
    assert got.dtype == convert.cache_from_jax(x).dtype
    r = np.asarray(ref)
    np.testing.assert_array_equal(
        convert.tensor_to_numpy_bits(got),
        r.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[r.dtype.itemsize]))


# ---- the segments engine: three-way equality (tests/test_engine.py) ------

TINY = dict(name="tiny", num_stacks=2, channels_per_stack=2,
            pcs_per_channel=2, bytes_per_pc=64 * 1024)
TGEO, JGEO = HBMGeometry(**TINY), JGeometry(**TINY)
TINY_TMAP = FaultMap.from_seed(TGEO, seed=7)
TINY_JMAP = JFaultMap.from_seed(JGEO, seed=7)


def _tree(dtype):
    rng = np.random.RandomState(3)
    if dtype == "int8":
        mk = lambda shape: rng.randint(-100, 100, shape).astype(np.int8)  # noqa: E731
    else:
        mk = lambda shape: rng.rand(*shape).astype(np.float32).astype(  # noqa: E731
            jnp.bfloat16 if dtype == "bfloat16" else np.float32)
    # ~47k words across three leaves: they straddle 3+ tiny PCs
    return {"a": mk((40000,)), "b": mk((123, 45)), "c": mk((4097,))}


def _place(tree, v, ecc_on):
    pcs = tuple(range(6))
    jp = jplace({"g": tree}, {"g": "d"},
                {"d": JDomain("d", v, pcs, ecc=ecc_on)}, JGEO)["g"]
    tt = convert.cache_from_jax(tree)
    tp = place_groups({"g": tt}, {"g": "d"},
                      {"d": MemoryDomain("d", v, pcs, ecc=ecc_on)}, TGEO)["g"]
    return jp, tp, tt


def _bits(t):
    return convert.tensor_to_numpy_bits(t)


def _count_calls(monkeypatch, module, name):
    """Count calls of a per-segment kernel wrapper as ``module`` calls it
    (on the CPU the wrapper runs its plain version, so _build.LAUNCHES
    stays 0)."""
    calls = []
    real = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("method,v", [("word", 0.90), ("bitwise", 0.86)])
def test_three_way_equality(dtype, method, v, monkeypatch):
    tree = _tree(dtype)
    jp, tp, tt = _place(tree, v, False)
    n_segments = sum(len(lp.segments) for lp in tp.leaves)
    assert len(set(tp.block_table().block_pc)) >= 2  # multi-PC arena
    calls = _count_calls(monkeypatch, tops, "bitflip")
    seg, bad = injection.inject_group(tt, tp, TINY_TMAP, method=method,
                                      engine="segments")
    assert len(calls) == n_segments             # one K5 call per segment
    arena, _ = injection.inject_group(tt, tp, TINY_TMAP, method=method)
    ref, _ = jinjection.inject_group(
        {k: jnp.asarray(a) for k, a in tree.items()}, jp, TINY_JMAP,
        method=method, use_ref=True)
    changed = 0
    for k in tree:
        np.testing.assert_array_equal(_bits(seg[k]), _bits(arena[k]))
        np.testing.assert_array_equal(_bits(arena[k]),
                                      _bits(convert.cache_from_jax(ref[k])))
        changed += int((_bits(seg[k]) != _bits(tt[k])).sum())
    assert changed > 0 and int(bad) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("v", [0.90, 0.88])
def test_three_way_equality_ecc(dtype, v, monkeypatch):
    tree = _tree(dtype)
    jp, tp, tt = _place(tree, v, True)
    calls = _count_calls(monkeypatch, tecc_ops, "segment_ecc")
    seg, bad_seg = injection.inject_group(tt, tp, TINY_TMAP,
                                          engine="segments")
    assert len(calls) == sum(len(lp.segments) for lp in tp.leaves)
    arena, bad_arena = injection.inject_group(tt, tp, TINY_TMAP)
    ref, bad_ref = jinjection.inject_group(
        {k: jnp.asarray(a) for k, a in tree.items()}, jp, TINY_JMAP,
        use_ref=True)
    for k in tree:
        np.testing.assert_array_equal(_bits(seg[k]), _bits(arena[k]))
        np.testing.assert_array_equal(_bits(arena[k]),
                                      _bits(convert.cache_from_jax(ref[k])))
    assert int(bad_seg) == int(bad_arena) == int(bad_ref)


def test_segments_engine_guardband_and_errors():
    tree = _tree("float32")
    _, tp, tt = _place(tree, 0.98, False)
    out, bad = injection.inject_group(tt, tp, TINY_TMAP, engine="segments")
    assert out is tt and int(bad) == 0
    with pytest.raises(ValueError, match="no voltage override"):
        injection.inject_group(tt, tp, TINY_TMAP, engine="segments",
                               voltage=0.9)
    with pytest.raises(ValueError, match="unknown engine"):
        injection.inject_group(tt, tp, TINY_TMAP, engine="bogus")


# ---- Algorithm 1 ----------------------------------------------------------

MEM_WORDS = 1 << 14


@pytest.mark.parametrize("v,pc,pattern,method,batch,transient", [
    (0.88, 19, jrel.ALL_ZEROS, "auto", 1, 0.0),
    (0.86, 0, jrel.ALL_ONES, "bitwise", 1, 0.0),
    (0.83, 0, jrel.ALL_ZEROS, "bitwise", 1, 0.0),
    (0.89, 4, jrel.ALL_ZEROS, "word", 3, 1e-5)])
def test_run_pc_test_matches_reference(v, pc, pattern, method, batch,
                                       transient):
    kw = dict(mem_words=MEM_WORDS, pattern=pattern, method=method,
              batch_size=batch, transient_rate=transient, seed=7)
    ref = jrel.run_pc_test(JMAP, v, pc, **kw)
    got = reliability.run_pc_test(TMAP, v, pc, device="cpu", **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    assert reliability.observed_rate(got) == jrel.observed_rate(ref)
    assert sum(got.fault_counts) > 0
    if transient:                   # the transient path varies batches
        assert len(set(got.fault_counts)) > 1


def test_sweep_matches_reference():
    kw = dict(pcs=[0, 19], mem_words=1 << 12, v_grid=[0.98, 0.90, 0.87],
              method="auto")
    ref = jrel.sweep(JMAP, **kw)
    timings = {}
    got = reliability.sweep(TMAP, device="cpu", timings=timings, **kw)
    assert list(got) == list(ref)
    for v in ref:
        assert ([dataclasses.astuple(r) for r in got[v]]
                == [dataclasses.astuple(r) for r in ref[v]])
    assert all(r.fault_counts == (0,) for r in got[0.98])
    assert sum(timings[f"tests_{m}"] for m in ("word", "bitwise")
               if f"tests_{m}" in timings) == 12
    assert np.array_equal(reliability.voltage_grid(), jrel.voltage_grid())


def test_count_flips_is_int64():
    """A full VCU128 PC at V_critical flips more than 2**31 bits: the
    count is summed in int64."""
    w = torch.zeros(4, dtype=torch.int32)
    r = torch.full((4,), -1, dtype=torch.int32)
    c = reliability.count_flips(w, r)
    assert c.dtype == torch.int64 and int(c) == 128


# ---- on the card ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(8 * 4096, 0), (70001, 0),
                                      (3 * 4096 + 6, 1)])
def test_segment_kernels_match_plain_on_card(cuda_device, n, offset):
    """K5 and K6 against their plain versions on the card: aligned runs,
    a ragged tail, an input not 16-byte aligned, and a run wrapping past
    word 2**32; K5 equals K1 over the same words laid out as blocks."""
    words = _t(_words(n + offset, 11))
    for v, pc, base in ((0.86, 3, 3 * PC_WORDS),
                        (0.88, 19, 2 ** 32 - 2 * 4096 - 7)):
        thr = TMAP.thresholds(v, pc)
        kw = dict(thresholds=thr, seed=TMAP.seed, base_word=base)
        x = words.to(cuda_device)[offset:]
        for method in ("word", "bitwise"):
            _build.reset_launch_counts()
            got = bitflip.bitflip(x, method=method, **kw)
            assert _build.launch_counts()["segment_bitflip"] == 1
            ref = bitflip.bitflip_ref(x, method=method, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (v, method)
            if offset == 0 and n % 4096 == 0:
                nb = n // 4096
                bb = torch.tensor(
                    [(base + 4096 * i) & 0xFFFFFFFF for i in range(nb)],
                    dtype=torch.int64)
                row = torch.tensor(bitflip.threshold_row(thr),
                                   dtype=torch.int64).expand(nb, 11)
                k1 = bitflip.arena_bitflip(
                    x, hashing.as_i32(bb).to(cuda_device),
                    hashing.as_i32(row).contiguous().to(cuda_device),
                    seed=TMAP.seed, method=method,
                    words_per_row_log2=thr.words_per_row_log2)
                assert torch.equal(got, k1)
        out, bad = ecc.segment_ecc(x, **kw)
        rout, rbad = ecc.segment_ecc_ref(x, **kw)
        torch.cuda.synchronize()
        assert torch.equal(out, rout) and torch.equal(bad, rbad)


@pytest.mark.cuda
def test_segments_engine_launches_per_segment_on_card(cuda_device):
    tree = _tree("bfloat16")
    _, tp, tt = _place(tree, 0.86, False)
    dev_tree = {k: t.to(cuda_device) for k, t in tt.items()}
    n_segments = sum(len(lp.segments) for lp in tp.leaves)
    _build.reset_launch_counts()
    seg, _ = injection.inject_group(dev_tree, tp, TINY_TMAP,
                                    method="bitwise", engine="segments")
    assert _build.launch_counts()["segment_bitflip"] == n_segments
    arena, _ = injection.inject_group(dev_tree, tp, TINY_TMAP,
                                      method="bitwise")
    assert _build.launch_counts()["arena_bitflip"] == 1
    for k in tt:
        assert torch.equal(seg[k].view(torch.int16),
                           arena[k].view(torch.int16))
