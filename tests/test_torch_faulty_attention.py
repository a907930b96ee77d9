"""The port's faulty decode attention (K3's plain version and its tile
helpers) held against the JAX reference in interpret mode.

Corruption of a K/V tile is integer math and must match bit for bit;
attention outputs agree within 1e-5 in float32 and 1e-2 in bf16 (sums
are taken in another order).  Inside the port, read-path corruption
must equal corrupt-then-attend bit for bit.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.domains import MemoryDomain as JDomain
from repro.core.domains import place_groups as jplace
from repro.core.faultmap import FaultMap as JFaultMap
from repro.core.hbm import HBMGeometry as JGeometry
from repro.kernels.flash_attention import faulty as jfaulty

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core.domains import MemoryDomain, place_groups
from repro_torch.core.faultmap import FaultMap
from repro_torch.core.hbm import HBMGeometry
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import faulty


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TINY = dict(name="tiny", num_stacks=2, channels_per_stack=2,
            pcs_per_channel=2, bytes_per_pc=64 * 1024)
TGEO, JGEO = HBMGeometry(**TINY), JGeometry(**TINY)
TMAP, JMAP = FaultMap.from_seed(TGEO, 7), JFaultMap.from_seed(JGEO, 7)
B, L, KH, G, D, P = 2, 64, 2, 3, 8, 2
H = KH * G
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _np_dtype(name):
    return jnp.bfloat16 if name == "bfloat16" else np.float32


@functools.lru_cache(maxsize=None)
def _setup(dtype, v, ecc):
    """Cache tree, its placement in both packages and the K/V leaf tables."""
    rng = np.random.RandomState(1)
    tree = {n: rng.randn(P, B, L, KH, D).astype(np.float32).astype(
        _np_dtype(dtype)) for n in ("k", "v")}
    tree["pos"] = np.repeat(np.arange(L, dtype=np.int32)[None], B, 0)
    tree["pos"] = np.repeat(tree["pos"][None], P, 0)
    domain = dict(name="d", voltage=v, pc_ids=tuple(range(6)), ecc=ecc)
    jp = jplace({"g": tree}, {"g": "d"}, {"d": JDomain(**domain)}, JGEO)["g"]
    tt = convert.cache_from_jax(tree)
    tp = place_groups({"g": tt}, {"g": "d"}, {"d": MemoryDomain(**domain)},
                      TGEO)["g"]
    jtab, ttab = {}, {}
    paths = [lp.path for lp in tp.leaves]
    jtabs, ttabs = jengine.leaf_block_tables(jp), engine.leaf_block_tables(tp)
    for n in ("k", "v"):
        i = paths.index(f"['{n}']")
        jtab[n] = (jnp.asarray(jtabs[i][0]),
                   JMAP.threshold_table(v)[jnp.asarray(jtabs[i][1])])
        ttab[n] = (ttabs[i][0], TMAP.threshold_table(v)[ttabs[i][1]])
    q = rng.randn(B, 1, H, D).astype(np.float32).astype(_np_dtype(dtype))
    return tree, tt, jtab, ttab, q, convert.tensor_from_numpy(q)


def _bits(t):
    return convert.tensor_to_numpy_bits(t)


@pytest.mark.parametrize("method,v,ecc", [("word", 0.87, False),
                                          ("bitwise", 0.86, False),
                                          ("word", 0.86, True)])
def test_corrupt_kv_tile_bit_exact(method, v, ecc):
    tree, tt, jtab, ttab, _, _ = _setup("bfloat16", v, ecc)
    layer, b, t0, rows = 1, 1, 16, 48
    wps = KH * D // 2
    word0 = layer * B * L * wps + (b * L + t0) * wps
    x = tree["k"][layer, b, t0:t0 + rows].reshape(rows, KH * D)
    slot_ids = t0 + np.arange(rows)
    ref = jfaulty.corrupt_kv_tile(
        jnp.asarray(x), jnp.uint32(word0), *jtab["k"],
        num_blocks=int(jtab["k"][0].shape[0]), n_cand=3, seed=JMAP.seed,
        method=method, words_per_row_log2=JMAP.words_per_row_log2, ecc=ecc,
        slot_ids=jnp.asarray(slot_ids, jnp.int32), clean_slot=jnp.int32(20))
    got = faulty.corrupt_kv_tile(
        tt["k"][layer, b, t0:t0 + rows].reshape(rows, KH * D), word0,
        *ttab["k"], seed=TMAP.seed, method=method,
        words_per_row_log2=TMAP.words_per_row_log2, ecc=ecc,
        slot_ids=torch.from_numpy(slot_ids), clean_slot=20)
    np.testing.assert_array_equal(_bits(got),
                                  np.asarray(ref).view(np.uint16))
    assert (_bits(got) != x.view(np.uint16)).any()
    np.testing.assert_array_equal(_bits(got)[20 - t0], x.view(np.uint16)[20 - t0])


def _attend(fn, q, k, v, pos, tabs, *, inject, ecc, window, method, seed,
            wprl2, clean, word0, **extra):
    return fn(q, k, v, pos, q_pos=L + 4, k_tables=tabs["k"],
              v_tables=tabs["v"], k_word0=word0, v_word0=word0, causal=True,
              window=window, seed=seed, method=method,
              words_per_row_log2=wprl2, ecc=ecc, inject=inject,
              clean_slot=clean, **extra)


# inject on/off x ECC on/off x window, spread over both dtypes (each case
# compiles its own interpret-mode program on the reference side).
@pytest.mark.parametrize("dtype,inject,ecc,window", [
    ("float32", False, False, 0), ("float32", True, False, 24),
    ("float32", True, True, 0), ("bfloat16", False, False, 24),
    ("bfloat16", True, False, 0), ("bfloat16", True, True, 24)])
def test_faulty_decode_attention_matches_jax(dtype, inject, ecc, window):
    v = 0.87 if ecc else 0.88
    tree, tt, jtab, ttab, q, tq = _setup(dtype, v, ecc)
    layer = 1
    wps = KH * D * (2 if dtype == "float32" else 1) // 2
    word0 = layer * B * L * wps
    pos = tree["pos"][layer].copy()
    pos[:, -3:] = -1                              # empty ring slots
    kw = dict(inject=inject, ecc=ecc, window=window, method="word",
              clean=5, word0=word0)
    ref = _attend(jfaulty.faulty_decode_attention, jnp.asarray(q),
                  jnp.asarray(tree["k"][layer]), jnp.asarray(tree["v"][layer]),
                  jnp.asarray(pos), jtab, seed=JMAP.seed,
                  wprl2=JMAP.words_per_row_log2, interpret=True, bkv=32,
                  **{**kw, "clean": jnp.int32(5), "word0": jnp.uint32(word0)})
    got = _attend(faulty.faulty_decode_attention, tq, tt["k"][layer],
                  tt["v"][layer], torch.from_numpy(pos), ttab,
                  seed=TMAP.seed, wprl2=TMAP.words_per_row_log2, bkv=32, **kw)
    ref = np.asarray(ref).astype(np.float32)
    got = got.float().numpy()
    assert np.isfinite(ref).all() == np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("method,v,ecc", [("word", 0.88, False),
                                          ("bitwise", 0.86, False),
                                          ("word", 0.86, True)])
def test_read_path_equals_corrupt_then_attend(method, v, ecc):
    """Inside the port: corrupting at load (clean slot exempt) is bit-
    identical to attending over the cache corrupted by the write path
    with the current slot's value still clean."""
    _, tt, _, ttab, _, tq = _setup("bfloat16", v, ecc)
    domain = MemoryDomain("d", v, tuple(range(6)), ecc=ecc)
    tp = place_groups({"g": tt}, {"g": "d"}, {"d": domain}, TGEO)["g"]
    corr = {n: t.clone() for n, t in tt.items()}
    engine.inject_placement_slice(corr, tp, TMAP, voltage=v, method=method)
    layer, clean = 1, 5
    word0 = layer * B * L * KH * D // 2
    kc, vc = corr["k"][layer].clone(), corr["v"][layer].clone()
    kc[:, clean] = tt["k"][layer][:, clean]
    vc[:, clean] = tt["v"][layer][:, clean]
    kw = dict(ecc=ecc, window=0, method=method, seed=TMAP.seed,
              wprl2=TMAP.words_per_row_log2, word0=word0)
    pos = tt["pos"][layer]
    read = _attend(faulty.faulty_decode_attention, tq, tt["k"][layer],
                   tt["v"][layer], pos, ttab, inject=True, clean=clean, **kw)
    write = _attend(faulty.faulty_decode_attention, tq, kc, vc, pos, ttab,
                    inject=False, clean=clean, **kw)
    np.testing.assert_array_equal(_bits(read), _bits(write))
    clean_out = _attend(faulty.faulty_decode_attention, tq, tt["k"][layer],
                        tt["v"][layer], pos, ttab, inject=False, clean=clean,
                        **kw)
    assert (_bits(read) != _bits(clean_out)).any()


def test_tile_helpers_match_reference():
    for ln, wps in ((64, 16), (1024, 512), (40, 8), (96, 1000)):
        assert faulty.pick_bkv(ln, wps) == jfaulty.pick_bkv(ln, wps)
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32,
                                                     jnp.float32)):
        assert faulty.packing(dt) == jfaulty.packing(jdt)
        assert (faulty.kv_words_per_slot(8, 128, dt)
                == jfaulty.kv_words_per_slot(8, 128, jdt))
    with pytest.raises(ValueError):
        faulty.kv_words_per_slot(1, 3, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("inject,ecc", [(False, False), (True, False),
                                        (True, True)])
def test_faulty_decode_kernel_matches_plain_on_card(cuda_device, inject, ecc):
    v = 0.87 if ecc else 0.88
    _, tt, _, ttab, _, tq = _setup("bfloat16", v, ecc)
    dev = lambda t: t.to(cuda_device)  # noqa: E731
    tabs = {n: tuple(dev(t) for t in ttab[n]) for n in ttab}
    args = (dev(tq), dev(tt["k"][1]), dev(tt["v"][1]), dev(tt["pos"][1]))
    kw = dict(q_pos=L + 4, k_tables=tabs["k"], v_tables=tabs["v"],
              k_word0=B * L * KH * D // 2, v_word0=B * L * KH * D // 2,
              seed=TMAP.seed, method="word",
              words_per_row_log2=TMAP.words_per_row_log2, ecc=ecc,
              inject=inject, clean_slot=5)
    _build.reset_launch_counts()
    got = faulty.faulty_decode_attention(*args, **kw)
    assert _build.launch_counts()["faulty_decode"] == 1
    ref = faulty.faulty_decode_attention_ref(*args, **kw)
    torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2, atol=1e-2,
                               equal_nan=True)


# ---------------------------------------------------------------------------
# the split ring of K3 and K4 (flash-decoding)
# ---------------------------------------------------------------------------


def _split_bounds(length, tile):
    """Tile ranges [a, b) of each split of a ring, as decode_splits says."""
    tps, n = faulty.decode_splits(length, tile)
    n_tiles = length // tile
    return [(i * tps, min((i + 1) * tps, n_tiles)) for i in range(n)]


@pytest.mark.parametrize("length,tile,expect", [   # at 128-slot splits
    (1024, 8, 8), (1024, 128, 8),        # K4's and K3's main-path rings
    (400, 8, 4), (400, 40, 4),           # ragged last splits
    (168, 8, 2),                         # a window ring of 21 pages
    (200, 200, 1),                       # a tile longer than a split
    (64, 64, 1), (96, 96, 1), (12, 1, 1), (8, 8, 1)])
def test_decode_splits_cover_the_ring_once_in_whole_tiles(length, tile,
                                                          expect):
    tps, n = faulty.decode_splits(length, tile)
    bounds = _split_bounds(length, tile)
    assert n == expect == len(bounds)
    assert tps == max(1, faulty.SPLIT_SLOTS // tile)
    assert [t for a, b in bounds for t in range(a, b)] == list(
        range(length // tile))
    assert all(b - a == tps for a, b in bounds[:-1])
    assert 0 < bounds[-1][1] - bounds[-1][0] <= tps


def test_decode_splits_read_only_the_ring_and_the_tile():
    """The split is a function of (length, tile) alone: no batch, slot
    count or device enters it, so a row splits alike at any batch, and K4
    over n pages of PS slots splits like K3 over n * PS slots at bkv PS."""
    import inspect
    assert list(inspect.signature(faulty.decode_splits).parameters) == [
        "length", "tile"]
    for n_lp, ps in ((128, 8), (50, 8), (21, 8), (4, 16), (3, 32)):
        assert faulty.decode_splits(n_lp * ps, ps) == (
            max(1, faulty.SPLIT_SLOTS // ps),
            -(-n_lp // max(1, faulty.SPLIT_SLOTS // ps)))
    for length, tile in ((100, 8), (0, 8), (64, 0)):
        with pytest.raises(ValueError):
            faulty.decode_splits(length, tile)


SPLIT_L = 400          # 50 tiles of 8 slots: 4 splits, the last two tiles


def _split_ring_operands(v, rows=4, seed=11):
    """A bf16 ring of SPLIT_L slots whose rows cover the split edge cases
    (row 0 wrapped: positions SPLIT_L.. in slots 0..5; row 1 partly empty;
    row 2 holding only its first split; row 3 empty), random block tables
    of 64 words with the tiny map's threshold rows at v, and a query."""
    rng = np.random.RandomState(seed)
    kv = [torch.from_numpy(rng.randn(rows, SPLIT_L, KH, D).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2)]
    ring = np.arange(SPLIT_L)
    pos = np.stack([np.where(ring < 6, ring + SPLIT_L, ring),
                    np.where(ring < 150, ring, -1),
                    np.where(ring < 60, ring, -1),
                    np.full(SPLIT_L, -1)]).astype(np.int32)
    lg2 = 6
    nblk = (rows * SPLIT_L * KH * D // 2) >> lg2
    thr = TMAP.threshold_table(v)
    tabs = {n: (torch.from_numpy(rng.randint(0, 1 << 20, nblk).astype(
        np.int32) << lg2), thr[torch.from_numpy(rng.randint(
            0, thr.shape[0], nblk))].contiguous()) for n in ("k", "v")}
    q = torch.from_numpy(rng.randn(rows, 1, H, D).astype(np.float32)).to(
        torch.bfloat16)
    return q, kv[0], kv[1], torch.from_numpy(pos), tabs, lg2


@pytest.mark.cuda
@pytest.mark.parametrize("bkv", [8, 40])
@pytest.mark.parametrize("inject,ecc,window", [
    (False, False, 0), (True, False, 0), (True, False, 100),
    (True, True, 0)])
def test_faulty_decode_kernel_split_ring_on_card(cuda_device, bkv, inject,
                                                 ecc, window):
    """K3 over a ring of several splits (a ragged last one at bkv 8)
    against its plain version, and at B = 4 equal on bits to each row
    launched alone."""
    v = 0.87 if ecc else 0.88
    q, k, v_, pos, tabs, lg2 = _split_ring_operands(v)
    dev = lambda t: t.to(cuda_device)  # noqa: E731
    q, k, v_, pos = dev(q), dev(k), dev(v_), dev(pos)
    tabs = {n: tuple(dev(t) for t in tabs[n]) for n in tabs}
    assert faulty.decode_splits(SPLIT_L, bkv)[1] > 1
    kw = dict(q_pos=SPLIT_L + 5, k_tables=tabs["k"], v_tables=tabs["v"],
              window=window, seed=TMAP.seed, method="word",
              words_per_row_log2=TMAP.words_per_row_log2, ecc=ecc,
              inject=inject, clean_slot=5, bkv=bkv, words_log2=lg2)
    _build.reset_launch_counts()
    got = faulty.faulty_decode_attention(q, k, v_, pos, k_word0=0,
                                         v_word0=0, **kw)
    assert _build.launch_counts()["faulty_decode"] == 1
    ref = faulty.faulty_decode_attention_ref(q, k, v_, pos, k_word0=0,
                                             v_word0=0, **kw)
    torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2, atol=1e-2,
                               equal_nan=True)
    wps = KH * D // 2
    for b in range(q.shape[0]):
        one = faulty.faulty_decode_attention(
            q[b:b + 1], k[b:b + 1], v_[b:b + 1], pos[b:b + 1],
            k_word0=b * SPLIT_L * wps, v_word0=b * SPLIT_L * wps, **kw)
        assert torch.equal(_bits16(one), _bits16(got[b:b + 1])), b


def _bits16(t):
    return t.contiguous().view(torch.int16)
