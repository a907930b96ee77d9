"""The port's injection math and arena engine held against the JAX
reference, bit for bit: word/bitwise masks, SECDED events, whole-group
arena injection (against the reference's interpret-mode kernel and its
oracle, with counts) and the incremental slice write path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.domains import MemoryDomain as JDomain
from repro.core.domains import place_groups as jplace
from repro.core.faultmap import FaultMap as JFaultMap
from repro.core.hbm import HBMGeometry as JGeometry
from repro.kernels.bitflip import ref as jref
from repro.kernels.ecc import ref as jecc
from repro.kernels.flash_attention import faulty as jfaulty
from repro.models.base import ParamSpec as JParamSpec
from repro.models.base import cache_slot_axes as jslot_axes

from repro_torch import convert
from repro_torch.core import engine, hashing
from repro_torch.core.domains import MemoryDomain, place_groups
from repro_torch.core.faultmap import FaultMap
from repro_torch.core.hbm import HBMGeometry
from repro_torch.core.injection import inject_group
from repro_torch.kernels import _build
from repro_torch.kernels.bitflip import bitflip
from repro_torch.kernels.bitflip import ref as tref
from repro_torch.kernels.ecc import ecc
from repro_torch.kernels.ecc import ref as tecc
from repro_torch.models.base import ParamSpec, cache_slot_axes


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


TINY = dict(name="tiny", num_stacks=2, channels_per_stack=2,
            pcs_per_channel=2, bytes_per_pc=64 * 1024)
TGEO, JGEO = HBMGeometry(**TINY), JGeometry(**TINY)
TMAP, JMAP = FaultMap.from_seed(TGEO, 7), JFaultMap.from_seed(JGEO, 7)
SEED = TMAP.seed
WPRL2 = TMAP.words_per_row_log2


def _u32(x):
    return np.asarray(x).astype(np.uint32)


def _per_word_thresholds(rng, n, v):
    """Threshold columns per word from random PCs of the table at v."""
    table = TMAP.threshold_table(v).numpy().view(np.uint32)
    rows = table[rng.randint(0, table.shape[0], n)]
    return ([jnp.asarray(rows[:, c]) for c in range(11)],
            [torch.from_numpy(rows[:, c].astype(np.int64)) for c in range(11)])


@pytest.mark.parametrize("method,v", [("word", 0.88), ("bitwise", 0.86)])
def test_word_and_bitwise_masks_bit_exact(method, v):
    rng = np.random.RandomState(int(v * 1000))
    wid = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    jt, tt = _per_word_thresholds(rng, wid.size, v)
    jw, tw = jnp.asarray(wid), torch.from_numpy(wid.astype(np.int64))
    if method == "word":
        names = dict(q01_weak=0, q01_strong=1, q10_weak=2, q10_strong=3)
        fj, ft = jref.word_masks, tref.word_masks
    else:
        names = dict(t01_weak=5, t01_strong=6, t10_weak=7, t10_strong=8)
        fj, ft = jref.bitwise_masks, tref.bitwise_masks
    ref = jax.jit(lambda w, t: fj(
        w, SEED, **{k: t[c] for k, c in names.items()}, weak_row_q=t[4],
        words_per_row_log2=WPRL2))(jw, jt)
    got = ft(tw, SEED, **{k: tt[c] for k, c in names.items()},
             weak_row_q=tt[4], words_per_row_log2=WPRL2)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), _u32(r))
    assert int(np.count_nonzero(np.asarray(ref[0]) | np.asarray(ref[1]))) > 0


@pytest.mark.parametrize("v", [0.86, 0.88])
def test_ecc_events_bit_exact(v):
    rng = np.random.RandomState(3)
    data = rng.randint(0, 2 ** 32, (64, 128), dtype=np.uint64).astype(np.uint32)
    wid = (np.arange(64 * 128, dtype=np.uint64).reshape(64, 128) * 7
           + 4096 * 5).astype(np.uint32)
    wid[:, 1::2] = wid[:, 0::2] + 1          # codewords: adjacent words
    table = TMAP.threshold_table(v).numpy().view(np.uint32)
    rows = table[np.repeat(rng.randint(0, 8, (64, 64)), 2, axis=1)]
    cols = dict(q01_weak=0, q01_strong=1, q10_weak=2, q10_strong=3,
                weak_row_q=4, par_q_weak=9, par_q_strong=10)
    ref = jax.jit(lambda d, w, r: jecc.ecc_codeword_events(
        d, w, SEED, **{k: r[..., c] for k, c in cols.items()},
        words_per_row_log2=WPRL2))(jnp.asarray(data), jnp.asarray(wid),
                                   jnp.asarray(rows))
    got = tecc.ecc_codeword_events(
        torch.from_numpy(data.astype(np.int64)),
        torch.from_numpy(wid.astype(np.int64)), SEED,
        **{k: torch.from_numpy(rows[..., c].astype(np.int64))
           for k, c in cols.items()},
        words_per_row_log2=WPRL2)
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32),
                                  _u32(ref[0]))
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert bool(np.asarray(ref[1]).any()) and bool(np.asarray(ref[2]).any())


def _group(rng):
    """Leaves of three dtypes packing into a 4-block arena."""
    return {"a": rng.randn(3000).astype(np.float32),
            "b": rng.randn(2, 4100).astype(np.float32).astype(
                jnp.bfloat16),
            "c": rng.randint(-100, 100, 5000).astype(np.int8)}


def _placements(tree, v, ecc_on, pcs=(2, 5, 1)):
    jp = jplace({"g": tree}, {"g": "d"},
                {"d": JDomain("d", v, pcs, ecc=ecc_on)}, JGEO)["g"]
    tt = convert.cache_from_jax(tree)
    tp = place_groups({"g": tt}, {"g": "d"},
                      {"d": MemoryDomain("d", v, pcs, ecc=ecc_on)}, TGEO)["g"]
    return jp, tp, tt


def _assert_tree_bits(got, ref):
    for k in ref:
        np.testing.assert_array_equal(
            convert.tensor_to_numpy_bits(got[k]),
            np.asarray(ref[k]).view(
                {1: np.uint8, 2: np.uint16, 4: np.uint32}[
                    np.asarray(ref[k]).dtype.itemsize]).reshape(
                        got[k].shape), err_msg=k)


@pytest.mark.parametrize("method,v,ecc_on", [
    ("word", 0.88, False), ("bitwise", 0.86, False), ("word", 0.87, True)])
def test_inject_placement_matches_jax_kernel_and_oracle(method, v, ecc_on):
    tree = _group(np.random.RandomState(11))
    jp, tp, tt = _placements(tree, v, ecc_on)
    assert tp.block_table().num_blocks == 4
    jtree = {k: jnp.asarray(a) for k, a in tree.items()}
    kern, kbad, kcorr = jax.jit(lambda t: jengine.inject_placement(
        t, jp, JMAP, method=method, interpret=True, with_corrected=True))(jtree)
    orac, obad, ocorr = jax.jit(lambda t: jengine.inject_placement(
        t, jp, JMAP, method=method, use_ref=True, with_corrected=True))(jtree)
    _build.reset_launch_counts()
    got, bad, corr = engine.inject_placement(tt, tp, TMAP, method=method,
                                             with_corrected=True)
    assert sum(_build.launch_counts().values()) == 0   # CPU: plain path
    _assert_tree_bits(got, kern)
    _assert_tree_bits(got, orac)
    assert int(bad) == int(kbad) == int(obad)
    assert int(corr) == int(kcorr) == int(ocorr)
    changed = sum(int((convert.tensor_to_numpy_bits(got[k])
                       != convert.tensor_to_numpy_bits(tt[k])).sum())
                  for k in tt)
    assert changed > 0
    if ecc_on:
        assert int(corr) > 0
    ref_ug, ref_bad = inject_group(tt, tp, TMAP, method=method, use_ref=True)
    _assert_tree_bits(ref_ug, kern)


def test_guardband_and_empty_group_are_identity():
    tree = _group(np.random.RandomState(2))
    _, tp, tt = _placements(tree, 0.98, False)
    out, bad = engine.inject_placement(tt, tp, TMAP)
    assert out is tt and int(bad) == 0


B, L, KH, D, P = 2, 32, 2, 8, 2


def _cache_tree(rng, dtype):
    if dtype == "bfloat16":
        mk = lambda: rng.randn(P, B, L, KH, D).astype(np.float32).astype(  # noqa: E731
            jnp.bfloat16)
    else:
        mk = lambda: rng.randint(-100, 100, (P, B, L, KH, D)).astype(  # noqa: E731
            np.int8)
    return {"k": mk(), "v": mk(),
            "pos": rng.randint(-1, 60, (P, B, L)).astype(np.int32)}


def _slot_axes(jax_side):
    kv_axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    Spec, fn = ((JParamSpec, jslot_axes) if jax_side
                else (ParamSpec, cache_slot_axes))
    dt = jnp.int8 if jax_side else torch.int8
    i32 = jnp.int32 if jax_side else torch.int32
    return fn({"k": Spec((P, B, L, KH, D), kv_axes, dt),
               "v": Spec((P, B, L, KH, D), kv_axes, dt),
               "pos": Spec((P, B, L), ("layers", "batch", "cache_seq"), i32)})


@pytest.mark.parametrize("method,v,ecc_on,dtype,pos", [
    ("word", 0.87, False, "int8", 37), ("word", 0.86, True, "int8", 40),
    ("word", 0.86, True, "bfloat16", None)])
def test_inject_placement_slice_bit_exact(method, v, ecc_on, dtype, pos):
    """Incremental write path (one ring slot, or whole leaves with
    pos=None) against the reference's, on the same operands."""
    tree = _cache_tree(np.random.RandomState(3), dtype)
    jp, tp, tt = _placements(tree, v, ecc_on, pcs=tuple(range(6)))
    jtree = {k: jnp.asarray(a) for k, a in tree.items()}
    ref, jbad = jax.jit(lambda t: jengine.inject_placement_slice(
        t, jp, JMAP, slot_axes=_slot_axes(True),
        pos=None if pos is None else jnp.int32(pos), voltage=v,
        method=method))(jtree)
    got, bad = engine.inject_placement_slice(
        tt, tp, TMAP, slot_axes=_slot_axes(False), pos=pos, voltage=v,
        method=method)
    _assert_tree_bits(got, ref)
    assert int(bad) == int(jbad)
    assert any((convert.tensor_to_numpy_bits(got[k])
                != tree[k].view({1: np.uint8, 2: np.uint16, 4: np.uint32}[
                    tree[k].dtype.itemsize])).any() for k in tree)


@pytest.mark.parametrize("start", [0, 1, 4095, 4096 + 17])
def test_select_block_tables_gather_matches_jax_selects(start):
    rng = np.random.RandomState(6)
    tree = {"k": rng.randn(40000).astype(np.float32)}
    jp, tp, _ = _placements(tree, 0.90, False, pcs=(0, 3, 5))
    (jbb, jbp), = jengine.leaf_block_tables(jp)
    (tbb, tbp), = engine.leaf_block_tables(tp)
    np.testing.assert_array_equal(tbb.numpy().view(np.uint32), jbb)
    jthr = JMAP.threshold_table(0.90)[jnp.asarray(jbp)]
    tthr = TMAP.threshold_table(0.90)[tbp]
    words = 3 * 4096 + 123
    off = np.uint32(start) + np.arange(words, dtype=np.uint32)
    wid_s, thr_s = jfaulty.select_block_tables(
        jnp.asarray(off), jnp.asarray(jbb), jthr, j0=jnp.int32(start // 4096),
        n_cand=-(-words // 4096) + 1, num_blocks=jbb.shape[0])
    wid_g, thr_g = bitflip.select_block_tables(
        torch.from_numpy(off.astype(np.int64)), tbb, tthr)
    np.testing.assert_array_equal(wid_g.numpy().astype(np.uint32),
                                  np.asarray(wid_s))
    for c in range(11):
        np.testing.assert_array_equal(thr_g[c].numpy().astype(np.uint32),
                                      np.asarray(thr_s[c]))


@pytest.mark.parametrize("ecc_on", [False, True])
def test_arena_wrappers_take_plain_version_on_cpu(ecc_on):
    rng = np.random.RandomState(8)
    nb = 3
    arena = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, nb * 4096,
                                         dtype=np.int64).astype(np.int32))
    base = hashing.as_i32(torch.tensor([0, 8192, 4096 * 9]))
    thr = TMAP.threshold_table(0.87)[torch.tensor([0, 3, 5])]
    _build.reset_launch_counts()
    if ecc_on:
        out, bad, corr = ecc.arena_ecc(arena, base, thr, seed=SEED,
                                       words_per_row_log2=WPRL2)
        ref = ecc.arena_ecc_ref(arena, base, thr, seed=SEED,
                                words_per_row_log2=WPRL2)
        assert torch.equal(bad, ref[1]) and torch.equal(corr, ref[2])
        ref = ref[0]
    else:
        out = bitflip.arena_bitflip(arena, base, thr, seed=SEED,
                                    method="word", words_per_row_log2=WPRL2)
        ref = bitflip.arena_bitflip_ref(arena, base, thr, seed=SEED,
                                        method="word",
                                        words_per_row_log2=WPRL2)
    assert torch.equal(out, ref) and not torch.equal(out, arena)
    assert _build.launch_counts() == {"arena_bitflip": 0, "arena_ecc": 0,
                                      "arena_ecc_events": 0,
                                      "faulty_decode": 0, "paged_decode": 0,
                                      "segment_bitflip": 0, "segment_ecc": 0,
                                      "flash_prefill": 0, "rglru_scan": 0}
    with pytest.raises(ValueError):
        bitflip.arena_bitflip(arena[:-1], base, thr, seed=SEED,
                              method="word", words_per_row_log2=WPRL2)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["word", "bitwise", "ecc"])
def test_arena_kernels_match_plain_on_card(cuda_device, method):
    rng = np.random.RandomState(9)
    nb = 64
    arena = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31, nb * 4096,
                                         dtype=np.int64).astype(np.int32))
    base = hashing.as_i32(torch.arange(nb, dtype=torch.int64) * 4096 + 4096 * 3)
    v = 0.86 if method == "bitwise" else 0.88
    thr = TMAP.threshold_table(v)[torch.arange(nb) % 8]
    dev = [t.to(cuda_device) for t in (arena, base, thr)]
    kw = dict(seed=SEED, words_per_row_log2=WPRL2)
    if method == "ecc":
        got = ecc.arena_ecc(*dev, **kw)
        ref = ecc.arena_ecc_ref(*dev, **kw)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    else:
        got = bitflip.arena_bitflip(*dev, method=method, **kw)
        assert torch.equal(got, bitflip.arena_bitflip_ref(*dev, method=method,
                                                          **kw))
