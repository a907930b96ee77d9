"""The port's paged KV-cache primitives held against the JAX reference.

Integer paths match bit for bit: the weak-row mask, the page refinement
of block tables, the paged ring write, page-tile corruption (with its
ECC telemetry counts) and the page pool's classes, tier allocation
order, prefix cache and exported request placements.  The plain paged
decode attention (K4's plain version) agrees with the reference's in
interpret mode within the bf16 tolerance below, and inside the port it
equals the plain contiguous version (K3's) over the same words bit for
bit -- the paged == contiguous contract.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.domains import MemoryDomain as JDomain
from repro.core.domains import place_groups as jplace
from repro.core.faultmap import FaultMap as JFaultMap
from repro.core.hbm import VCU128 as JVCU128
from repro.core.hbm import HBMGeometry as JGeometry
from repro.kernels.flash_attention import faulty as jfaulty
from repro.models import cache as jcache
from repro.models.base import get_arch as jget_arch
from repro.serving.paged import PagedKVCache as JPagedKVCache
from repro.serving.paged import PagePool as JPagePool
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core import hashing as H
from repro_torch.core import pytree
from repro_torch.core.domains import CapacityError, MemoryDomain
from repro_torch.core.faultmap import FaultMap
from repro_torch.core.hbm import VCU128, HBMGeometry
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import faulty
from repro_torch.models import cache
from repro_torch.models.base import get_arch
from repro_torch.serving.paged import (PagedKVCache, PagedLayoutError,
                                       PagePool, PageSharingError)
from repro_torch.training.undervolt import UndervoltPlan


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
B, L, KH, G, D, PS = 2, 32, 2, 3, 8, 8
H_ = KH * G
N_LP = L // PS
# The reference test's cases: word path, bitwise path, ECC.
CASES = [("word", 0.88, False), ("bitwise", 0.86, False),
         ("word", 0.86, True)]
# K4's plain version against the reference, bf16 outputs: sums in another
# order may move an output by one bf16 rounding step.
BF16_TOL = 1e-2


def _i32(a):
    return H.as_i32(torch.from_numpy(np.asarray(a).astype(np.int64)))


def _operands(seed, v, ecc):
    """One contiguous (B, L, KH, D) bf16 cache placed on the tiny
    geometry, its page tables in both packages and a query."""
    rng = np.random.RandomState(seed)
    kv = {n: rng.randn(B, L, KH, D).astype(np.float32) for n in ("k", "v")}
    jtree = {n: jnp.asarray(a, jnp.bfloat16) for n, a in kv.items()}
    domains = {"d": JDomain("d", v, tuple(range(6)), ecc=ecc)}
    placement = jplace({"g": jtree}, {"g": "d"}, domains, JGEO)["g"]
    jtab, ttab = JMAP.threshold_table(v), TMAP.threshold_table(v)
    tabs = jengine.leaf_block_tables(placement)
    paths = [lp.path for lp in placement.leaves]
    page_words = PS * KH * D // 2
    jpage, tpage = {}, {}
    for n in ("k", "v"):
        bb, bp = tabs[paths.index(f"['{n}']")]
        pb, pp = jengine.refine_tables(bb, bp, page_words)
        jpage[n] = (jnp.asarray(pb), jtab[jnp.asarray(pp)])
        tpage[n] = (_i32(pb), ttab[torch.from_numpy(pp.astype(np.int64))])
    q = rng.randn(B, 1, H_, D).astype(np.float32)
    pos = np.arange(L)[None, :].repeat(B, 0).astype(np.int32)
    pos[:, -3:] = -1                     # empty ring slots stay masked
    ttree = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in kv.items()}
    return dict(jtree=jtree, ttree=ttree, jpage=jpage, tpage=tpage,
                q=q, pos=pos, page_words=page_words)


def _kw(method, ecc):
    return dict(causal=True, window=0, seed=TMAP.seed, method=method,
                words_per_row_log2=TMAP.words_per_row_log2, ecc=ecc)


PERM = np.random.RandomState(3).permutation(B * N_LP)


def _pool_view(tree, pos):
    """The contiguous cache as a page pool with a shuffled page table:
    pool page i holds contiguous page PERM[i]."""
    pk = tree["k"].reshape(B * N_LP, PS, KH, D)[PERM]
    pv = tree["v"].reshape(B * N_LP, PS, KH, D)[PERM]
    ppos = pos.reshape(B * N_LP, PS)[PERM]
    ptab = np.argsort(PERM).reshape(B, N_LP).astype(np.int32)
    return pk, pv, ppos, ptab


def _pool_tables(tables):
    """Page tables of the contiguous cache reordered to the pool's pages."""
    return tuple(t[PERM] for t in tables)


def _bits16(t):
    return t.contiguous().view(torch.int16)


# ---------------------------------------------------------------------------
# integer paths, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pc", [0, 5, 7])
def test_weak_row_mask_bit_exact(pc):
    np.testing.assert_array_equal(TMAP.weak_row_mask(pc),
                                  JMAP.weak_row_mask(pc))
    np.testing.assert_array_equal(TMAP.weak_block_mask(pc, 4096),
                                  JMAP.weak_block_mask(pc, 4096))


def test_weak_row_mask_full_geometry_and_rates():
    t, j = FaultMap.from_seed(VCU128, 469), JFaultMap.from_seed(JVCU128, 469)
    np.testing.assert_array_equal(t.weak_row_mask(18), j.weak_row_mask(18))
    for v in (0.88, 0.91):
        np.testing.assert_array_equal(t.predicted_rates(v),
                                      j.predicted_rates(v))
        np.testing.assert_array_equal(t.predicted_rates(v, True),
                                      j.predicted_rates(v, True))


def test_refine_tables_bit_exact_and_typed():
    bb = np.asarray([4096 * 7, 4096 * 11, 2 ** 32 - 4096], np.uint32)
    bp = np.asarray([3, 5, 31], np.int32)
    for page_words in (64, 512, 4096):
        got = engine.refine_tables(_i32(bb).numpy(), bp, page_words)
        ref = jengine.refine_tables(bb, bp, page_words)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="divide"):
        engine.refine_tables(bb, bp, 24)


def test_paged_update_bit_exact():
    rng = np.random.RandomState(4)
    n_pages, s, c, length = 9, 3, 5, 32
    pool = {"k": rng.randn(n_pages, PS, KH, D).astype(np.float32),
            "v": rng.randn(n_pages, PS, KH, D).astype(np.float32),
            "pos": rng.randint(-1, 40, (n_pages, PS)).astype(np.int32)}
    new = {n: rng.randn(s, c, KH, D).astype(np.float32) for n in ("k", "v")}
    ptab = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7], [8, 8, 8, 8]], np.int32)
    pos = np.asarray([[3, 4, 5, 6, 7], [13, 14, -1, -1, -1],
                      [30, 31, 32, 33, -1]], np.int32)
    wstart = np.asarray([5, 0, 0], np.int32)
    for kw in ({}, {"wstart": wstart, "scratch_id": 8}):
        ref = jcache.paged_update(
            {k: jnp.asarray(a) for k, a in pool.items()},
            {k: jnp.asarray(a) for k, a in new.items()}, jnp.asarray(pos),
            jnp.asarray(ptab), length, PS,
            **{k: (jnp.asarray(a) if k == "wstart" else a)
               for k, a in kw.items()})
        got = {k: torch.from_numpy(a.copy()) for k, a in pool.items()}
        cache.paged_update(
            got, {k: torch.from_numpy(a) for k, a in new.items()},
            torch.from_numpy(pos), torch.from_numpy(ptab), length, PS,
            **{k: (torch.from_numpy(a) if k == "wstart" else a)
               for k, a in kw.items()})
        live = np.ones(n_pages, bool)
        if kw:
            live[8] = False        # the scratch sink's contents are junk
        for k in pool:
            np.testing.assert_array_equal(got[k].numpy()[live],
                                          np.asarray(ref[k])[live],
                                          err_msg=k)


@pytest.mark.parametrize("method,v,ecc", CASES)
def test_corrupt_page_tile_bit_exact(method, v, ecc):
    rng = np.random.RandomState(5)
    tile = rng.randn(64, 512).astype(np.float32)   # 16 Ki words
    n_rows = tile.shape[0]
    base = 4096 * 3 + 64
    jt = JMAP.threshold_table(v)[2]
    tt = TMAP.threshold_table(v)[2]
    kw = dict(seed=TMAP.seed, method=method,
              words_per_row_log2=TMAP.words_per_row_log2, ecc=ecc)
    slot_ids = np.arange(n_rows, dtype=np.int32) + 8
    jkw = dict(kw, slot_ids=jnp.asarray(slot_ids), clean_slot=11)
    ref = jfaulty.corrupt_page_tile(
        jnp.asarray(tile, jnp.bfloat16), jnp.uint32(base),
        tuple(jt[c] for c in range(jt.shape[0])), with_counts=ecc, **jkw)
    got = faulty.corrupt_page_tile(
        torch.from_numpy(tile).to(torch.bfloat16)[None],
        torch.tensor([base]), tuple(tt[c:c + 1] for c in range(tt.shape[0])),
        slot_ids=torch.from_numpy(slot_ids)[None],
        clean_slot=torch.tensor([[11]]), with_counts=ecc, **kw)
    if ecc:
        (ref, rc), (got, gc) = ref, got
        assert int(gc[0]) == int(rc)
    ref_bits = np.asarray(jax.lax.bitcast_convert_type(ref, jnp.uint16))
    np.testing.assert_array_equal(_bits16(got[0]).numpy().view(np.uint16),
                                  ref_bits)
    assert (ref_bits != np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(tile, jnp.bfloat16), jnp.uint16))).any()


# ---------------------------------------------------------------------------
# the page pool against the reference's
# ---------------------------------------------------------------------------

JB, TB = jget_arch("llama3.2-3b"), get_arch("llama3.2-3b")
ALL = tuple(range(32))


def _pools(v=0.88, ecc=False, num_pages=16, page_slots=8, max_len=32):
    jplan = JPlan(domains={"kv": JDomain("kv", v, ALL, ecc=ecc)},
                  policy={"kv_cache": "kv"}, geometry=JVCU128)
    tplan = UndervoltPlan(domains={"kv": MemoryDomain("kv", v, ALL, ecc=ecc)},
                          policy={"kv_cache": "kv"}, geometry=VCU128)
    kw = dict(max_len=max_len, page_slots=page_slots, num_pages=num_pages)
    return (JPagePool(JB.module, JB.reduced, plan=jplan, **kw),
            PagePool(TB.module, TB.reduced, plan=tplan, **kw))


@pytest.mark.parametrize("v,ecc", [(0.88, False), (0.86, True)])
def test_pool_classes_tables_and_tier_order_bit_exact(v, ecc):
    jp, tp = _pools(v, ecc)
    assert tp._strong == jp._strong and tp._weak == jp._weak
    assert tp.num_weak_pages >= 1, "the map should make some pages weak"
    np.testing.assert_array_equal(tp._rate, jp._rate)
    for jl, tl in zip(jp.leaves, tp.leaves):
        assert (jl.path, jl.wps, jl.page_words, jl.n_pages) == (
            tl.path, tl.wps, tl.page_words, tl.n_pages)
        np.testing.assert_array_equal(tl.page_base, jl.page_base)
        np.testing.assert_array_equal(tl.page_pc, jl.page_pc)
    assert tp.request_words == jp.request_words
    # allocation order per tier, frees and re-allocation
    for tier, n in (("critical", 2), ("cheap", 3), ("hedged", 1),
                    ("shared_prefix", 2), ("disposable", 4)):
        np.testing.assert_array_equal(tp.alloc(n, tier), jp.alloc(n, tier))
    freed = np.asarray(sorted(jp._owned)[::3][:3], np.int32)
    jp.free(freed)
    tp.free(freed)
    assert tp._strong == jp._strong and tp._weak == jp._weak
    np.testing.assert_array_equal(tp.alloc(3, "cheap"), jp.alloc(3, "cheap"))
    with pytest.raises(CapacityError, match="weak"):
        tp.alloc(tp.free_pages + 1, "critical")


def test_pool_prefix_cache_and_request_placement_bit_exact():
    jp, tp = _pools()
    toks = np.arange(20, dtype=np.int32)
    pids = jp.alloc(4, "cheap")
    np.testing.assert_array_equal(tp.alloc(4, "cheap"), pids)
    for p in (jp, tp):
        p.share(pids[:3], ("__req__", "creator"))
        assert p.register_prefix(toks[:8], pids[:1])
        assert p.register_prefix(toks[:16], pids[:2])
        assert p.register_prefix(toks, pids[:3])
        assert not p.register_prefix(toks, pids[:3])
    other = np.concatenate([toks[:16], [999, 998]]).astype(np.int32)
    for probe in (toks, other, toks[:7], np.array([7, 7], np.int32)):
        (jl, jg), (tl, tg) = jp.match_prefix(probe), tp.match_prefix(probe)
        assert jl == tl
        np.testing.assert_array_equal(tg, jg)
    for p in (jp, tp):
        assert p.evict_prefix()
        p.release(pids[:3], ("__req__", "creator"))
    assert tp.shared_pages == jp.shared_pages and tp.prefix_entries == 2
    while tp.evict_prefix():
        assert jp.evict_prefix()
    assert tp._strong == jp._strong and tp._weak == jp._weak
    # request placement tables of a whole page-table row
    row = jp.alloc(jp.n_logical_pages, "cheap")
    np.testing.assert_array_equal(tp.alloc(tp.n_logical_pages, "cheap"), row)
    jr, tr = jp.request_placement(row), tp.request_placement(row)
    assert tr.map_seed == jr.map_seed and tr.total_words == jr.total_words
    for jl, tl in zip(jr.leaves, tr.leaves):
        assert (jl.path, jl.n_words, jl.page_words) == (
            tl.path, tl.n_words, tl.page_words)
        np.testing.assert_array_equal(tl.page_base, jl.page_base)
        np.testing.assert_array_equal(tl.page_pc, jl.page_pc)


def test_pool_typed_errors():
    _, tp = _pools()
    plan = tp.plan
    with pytest.raises(PagedLayoutError, match="divide"):
        PagePool(TB.module, TB.reduced, max_len=32, page_slots=7,
                 num_pages=4, plan=plan)
    with pytest.raises(PagedLayoutError, match="block size"):
        PagePool(TB.module, TB.reduced, max_len=24, page_slots=3,
                 num_pages=4, plan=plan)
    pids = tp.alloc(2, "cheap")
    with pytest.raises(PageSharingError, match="not a shared page"):
        tp.cow_fork(pids[0])
    tp.share(pids, ("__req__", "a"))
    with pytest.raises(PageSharingError, match="released per holder"):
        tp.free(pids)
    tp.release(pids, ("__req__", "a"))
    with pytest.raises(PageSharingError, match="double release"):
        tp.release(pids, ("__req__", "a"))
    with pytest.raises(ValueError, match="double free"):
        tp.free(pids)
    # free pages retire for good; an id outside the pool is refused
    tp.quarantine(pids)
    assert set(tp.quarantined_pages) == {int(q) for q in pids}
    assert tp.free_pages == tp.num_pages - len(pids)
    with pytest.raises(ValueError, match="invalid page id"):
        tp.quarantine([tp.num_pages])


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inject", [True, False])
@pytest.mark.parametrize("method,v,ecc", CASES)
def test_paged_attention_plain_matches_reference(method, v, ecc, inject):
    """K4's plain version against the reference kernel in interpret mode,
    over a shuffled page table; ECC telemetry counts exactly equal."""
    op = _operands(1, v, ecc)
    pk, pv, ppos, ptab = _pool_view(op["jtree"], op["pos"])
    tk, tv, tpos, _ = _pool_view(op["ttree"], torch.from_numpy(op["pos"]))
    q_pos = np.asarray([L + 4, L - 9], np.int32)
    tel = ecc and inject
    kw = _kw(method, ecc)
    ref = jfaulty.paged_decode_attention(
        jnp.asarray(op["q"], jnp.bfloat16), pk, pv, jnp.asarray(ppos),
        jnp.asarray(ptab), q_pos=jnp.asarray(q_pos),
        k_tables=_pool_tables(op["jpage"]["k"]),
        v_tables=_pool_tables(op["jpage"]["v"]), inject=inject,
        telemetry=tel, **kw)
    got = faulty.paged_decode_attention(
        torch.from_numpy(op["q"]).to(torch.bfloat16), tk, tv, tpos,
        torch.from_numpy(ptab), q_pos=torch.from_numpy(q_pos),
        k_tables=_pool_tables(op["tpage"]["k"]),
        v_tables=_pool_tables(op["tpage"]["v"]), inject=inject,
        telemetry=tel, **kw)
    if tel:
        (ref, rc), (got, gc) = ref, got
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
        assert int(gc.sum()) > 0
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=BF16_TOL,
                               atol=BF16_TOL, equal_nan=True)


@pytest.mark.parametrize("inject", [True, False])
@pytest.mark.parametrize("method,v,ecc", CASES)
def test_paged_equals_contiguous_bit_exact(method, v, ecc, inject):
    """Plain K4 over the pool == plain K3 over the same words through
    page-granular tables with a tile of one page, bit for bit; each slot
    alone gives its row of the batch."""
    op = _operands(2, v, ecc)
    tt = op["ttree"]
    pos = torch.from_numpy(op["pos"])
    tk, tv, tpos, ptab = _pool_view(tt, pos)
    pk_tab, pv_tab = (_pool_tables(op["tpage"][n]) for n in ("k", "v"))
    q = torch.from_numpy(op["q"]).to(torch.bfloat16)
    kw = _kw(method, ecc)
    lg2 = op["page_words"].bit_length() - 1
    cont = faulty.faulty_decode_attention(
        q, tt["k"], tt["v"], pos, q_pos=L + 4, k_tables=op["tpage"]["k"],
        v_tables=op["tpage"]["v"], k_word0=0, v_word0=0, inject=inject,
        bkv=PS, words_log2=lg2, **kw)
    paged = faulty.paged_decode_attention(
        q, tk, tv, tpos, torch.from_numpy(ptab),
        q_pos=torch.full((B,), L + 4, dtype=torch.int32),
        k_tables=pk_tab, v_tables=pv_tab, inject=inject, **kw)
    assert torch.equal(_bits16(cont), _bits16(paged))
    one = faulty.paged_decode_attention(
        q[1:], tk, tv, tpos, torch.from_numpy(ptab[1:]),
        q_pos=torch.full((1,), L + 4, dtype=torch.int32),
        k_tables=pk_tab, v_tables=pv_tab, inject=inject, **kw)
    assert torch.equal(_bits16(one), _bits16(paged[1:]))


@pytest.mark.cuda
@pytest.mark.parametrize("inject", [True, False])
@pytest.mark.parametrize("method,v,ecc", CASES)
def test_paged_kernel_matches_plain_and_k3_on_card(cuda_device, method, v,
                                                   ecc, inject):
    op = _operands(1, v, ecc)
    dev = lambda t: t.to(cuda_device)  # noqa: E731
    tt = {n: dev(t) for n, t in op["ttree"].items()}
    pos = dev(torch.from_numpy(op["pos"]))
    tk, tv, tpos, ptab = _pool_view(tt, pos)
    tk, tv, tpos = tk.contiguous(), tv.contiguous(), tpos.contiguous()
    tabs = {n: tuple(dev(t).contiguous() for t in op["tpage"][n])
            for n in ("k", "v")}
    ptabs = {n: tuple(t[PERM].contiguous() for t in tabs[n])
             for n in ("k", "v")}
    q = dev(torch.from_numpy(op["q"]).to(torch.bfloat16))
    tel = ecc and inject
    kw = dict(_kw(method, ecc), q_pos=dev(torch.full((B,), L + 4,
                                                     dtype=torch.int32)),
              k_tables=ptabs["k"], v_tables=ptabs["v"], inject=inject,
              telemetry=tel)
    args = (q, tk, tv, tpos, dev(torch.from_numpy(ptab)))
    _build.reset_launch_counts()
    got = faulty.paged_decode_attention(*args, **kw)
    assert _build.launch_counts()["paged_decode"] == 1
    ref = faulty.paged_decode_attention_ref(*args, **kw)
    if tel:
        (got, gc), (ref, rc) = got, ref
        assert torch.equal(gc, rc)
    torch.testing.assert_close(got.float(), ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL, equal_nan=True)
    lg2 = op["page_words"].bit_length() - 1
    cont = faulty.faulty_decode_attention(
        q, tt["k"], tt["v"], pos, q_pos=L + 4, k_tables=tabs["k"],
        v_tables=tabs["v"], k_word0=0, v_word0=0, inject=inject,
        bkv=PS, words_log2=lg2, **_kw(method, ecc))
    assert torch.equal(_bits16(cont), _bits16(got))


SPLIT_LP = 50          # a 400-slot ring of 8-slot pages: 4 splits, the last
                       # two pages


def _split_pool(v, n_lp, seed=12):
    """A bf16 pool of 4 slots x SPLIT_LP shuffled pages (plus a scratch
    page) read through the first n_lp columns of the page table (n_lp <
    SPLIT_LP: a window ring); slot 0 has wrapped, slot 1 is partly empty,
    slot 2 holds only its first split, slot 3 is empty.  Page tables:
    random bases of whole pages, the tiny map's threshold rows at v."""
    rng = np.random.RandomState(seed)
    slots, total = 4, 4 * SPLIT_LP + 1
    pool = [torch.from_numpy(rng.randn(total, PS, KH, D).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2)]
    ptab = rng.permutation(slots * SPLIT_LP).reshape(
        slots, SPLIT_LP)[:, :n_lp].astype(np.int32)
    length = n_lp * PS
    ring = np.arange(length)
    fills = (np.where(ring < 6, ring + length, ring),
             np.where(ring < length - 50, ring, -1),
             np.where(ring < 60, ring, -1), np.full(length, -1))
    pos = np.full((total, PS), -1, np.int32)
    for s_, f in enumerate(fills):
        pos[ptab[s_]] = f.reshape(n_lp, PS)
    q_pos = np.asarray([length + 5, length - 50, 60, 0], np.int32)
    page_words = PS * KH * D // 2
    thr = TMAP.threshold_table(v)
    tabs = {n: (torch.from_numpy(rng.randint(0, 1 << 20, total).astype(
        np.int32) * page_words), thr[torch.from_numpy(rng.randint(
            0, thr.shape[0], total))].contiguous()) for n in ("k", "v")}
    q = torch.from_numpy(rng.randn(slots, 1, H_, D).astype(np.float32)).to(
        torch.bfloat16)
    return (q, pool[0], pool[1], torch.from_numpy(pos),
            torch.from_numpy(ptab), torch.from_numpy(q_pos), tabs,
            page_words.bit_length() - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_lp", [SPLIT_LP, 21])
@pytest.mark.parametrize("inject", [True, False])
@pytest.mark.parametrize("method,v,ecc", CASES)
def test_paged_kernel_split_ring_on_card(cuda_device, method, v, ecc,
                                         inject, n_lp):
    """K4 over a ring of several splits (a ragged last one; a window ring)
    against its plain version and its telemetry, equal on bits to K3 over
    each slot's gathered words at a tile of one page, and each slot
    launched alone equal to its row."""
    dev = lambda t: t.to(cuda_device)  # noqa: E731
    q, pk, pv, ppos, ptab, q_pos, tabs, lg2 = (
        dev(t) if isinstance(t, torch.Tensor) else t
        for t in _split_pool(v, n_lp))
    tabs = {n: tuple(dev(t) for t in tabs[n]) for n in tabs}
    length = n_lp * PS
    assert faulty.decode_splits(length, PS)[1] > 1
    tel = ecc and inject
    kw = dict(_kw(method, ecc), k_tables=tabs["k"], v_tables=tabs["v"],
              inject=inject)
    _build.reset_launch_counts()
    got = faulty.paged_decode_attention(q, pk, pv, ppos, ptab, q_pos=q_pos,
                                        telemetry=tel, **kw)
    assert _build.launch_counts()["paged_decode"] == 1
    ref = faulty.paged_decode_attention_ref(q, pk, pv, ppos, ptab,
                                            q_pos=q_pos, telemetry=tel, **kw)
    if tel:
        (got, gc), (ref, rc) = got, ref
        assert torch.equal(gc, rc) and int(gc.sum()) > 0
    torch.testing.assert_close(got.float(), ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL, equal_nan=True)
    for s_ in range(q.shape[0]):
        pids = ptab[s_].long()
        qp = int(q_pos[s_])
        cont = faulty.faulty_decode_attention(
            q[s_:s_ + 1], pk[pids].reshape(1, length, KH, D).contiguous(),
            pv[pids].reshape(1, length, KH, D).contiguous(),
            ppos[pids].reshape(1, length).contiguous(), q_pos=qp,
            k_tables=tuple(t[pids].contiguous() for t in tabs["k"]),
            v_tables=tuple(t[pids].contiguous() for t in tabs["v"]),
            k_word0=0, v_word0=0, bkv=PS,
            words_log2=lg2, **{n: a for n, a in kw.items()
                               if n not in ("k_tables", "v_tables")})
        assert torch.equal(_bits16(cont), _bits16(got[s_:s_ + 1])), s_
        one = faulty.paged_decode_attention(
            q[s_:s_ + 1], pk, pv, ppos, ptab[s_:s_ + 1],
            q_pos=q_pos[s_:s_ + 1], **kw)
        assert torch.equal(_bits16(one), _bits16(got[s_:s_ + 1])), s_


def test_decode_splits_shared_by_k4_and_its_k3_replay():
    """The scheduler step's K4 (a tile of one page over each leaf's
    n_pages * page_slots ring) and a request's solo replay through the read
    path (K3 at the bkv its page-granular placement pins, over the leaf's
    ring) split every K/V ring alike, here into several splits with a
    ragged last one."""
    from repro_torch.models.base import spec_avals
    from repro_torch.serving import readpath
    max_len = 400
    _, tp = _pools(num_pages=56, max_len=max_len)
    placement = tp.request_placement(tp.alloc(tp.n_logical_pages, "cheap"))
    avals = spec_avals(TB.module.cache_specs(TB.reduced, 1, max_len))
    ctx = readpath.build_ctx(placement, tp.faultmap, avals, voltage=0.88,
                             method="word", inject=True, device="cpu")
    assert ctx.bkv == tp.page_slots
    kv = [leaf for leaf in tp.leaves if leaf.which in ("k", "v")]
    assert kv
    for leaf in kv:
        k4 = faulty.decode_splits(leaf.n_pages * tp.page_slots,
                                  tp.page_slots)
        assert k4 == faulty.decode_splits(leaf.length, ctx.bkv) == (16, 4)


# ---------------------------------------------------------------------------
# the pool's device-side data paths against the reference's, bit for bit
# ---------------------------------------------------------------------------


def _pool_trees(jp, seed):
    """The same random pool contents in both packages (positions valid)."""
    rng = np.random.RandomState(seed)
    jtree = jcache.init_cache(jp.pool_specs)

    def fill(a):
        if a.dtype == jnp.int32:
            return jnp.asarray(rng.randint(0, 32, a.shape), jnp.int32)
        return jnp.asarray(rng.randn(*a.shape), a.dtype)
    jtree = jax.tree.map(fill, jtree)
    ttree = convert.cache_from_jax(jax.tree.map(np.asarray, jtree))
    return jtree, ttree


def _assert_trees_equal(ttree, jtree):
    """Bits equal leaf by leaf.  Where both values are NaN the payloads
    may differ: XLA on the CPU canonicalizes a bf16 NaN when it scatters
    float values, while the port keeps the stuck-at bits."""
    jflat = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    for p, t in pytree.flatten_with_path(ttree):
        j = jflat[pytree.keystr(p)]
        got = convert.tensor_to_numpy_bits(t)
        ref = j.view({2: np.uint16, 4: np.uint32}[j.dtype.itemsize])
        if t.is_floating_point():
            both_nan = (torch.isnan(t.float()).numpy()
                        & np.isnan(j.astype(np.float32)))
            got, ref = got[~both_nan], ref[~both_nan]
        np.testing.assert_array_equal(got, ref, err_msg=pytree.keystr(p))


@pytest.mark.parametrize("ecc", [False, True])
def test_pool_write_paths_bit_exact(ecc):
    """Admission reset + copy-on-write fork, the transition injection of a
    request's pages and the per-step write-path injection of the slots a
    decode step wrote, on the same pool contents in both packages."""
    jp, tp = _pools(0.86, ecc, num_pages=12)
    jk, tk = JPagedKVCache(jp), PagedKVCache(tp, "cpu")
    jtree, ttree = _pool_trees(jp, 8)
    ids = np.asarray([3, 5, 7, 9], np.int32)
    jtree = jax.jit(jk.reset_and_fork)(jtree, jnp.asarray(ids), 1, 2, 3, 16)
    tk.reset_and_fork(ttree, ids, 1, 2, 3, 16)
    _assert_trees_equal(ttree, jtree)
    method = "word"         # the bitwise masks are held by the tile tests
    for skip in (False, True):
        jtree = jax.jit(functools.partial(
            jk.inject_pages, method=method, skip_kv=skip))(
                jtree, jnp.asarray(ids), jnp.float32(0.86))
        tk.inject_pages(ttree, ids, 0.86, method=method, skip_kv=skip)
        _assert_trees_equal(ttree, jtree)
    ptab = np.asarray([[3, 5, 7, 9], [0, 1, 2, 4]], np.int32)
    qpos = np.asarray([13, 30], np.int32)
    for mode in ("write", "read"):
        jtree = jax.jit(functools.partial(
            jk.post_step_inject, mode=mode, method=method))(
                jtree, jnp.asarray(ptab), jnp.asarray(qpos),
                jnp.float32(0.86))
        tk.post_step_inject(ttree, torch.from_numpy(ptab),
                            torch.from_numpy(qpos), 0.86, mode=mode,
                            method=method)
        _assert_trees_equal(ttree, jtree)


def test_scatter_request_bit_exact():
    jp, tp = _pools(num_pages=10)
    jtree, ttree = _pool_trees(jp, 9)
    rng = np.random.RandomState(10)
    jreq = jax.tree.map(
        lambda a: (jnp.asarray(rng.randint(-1, 32, a.shape), jnp.int32)
                   if a.dtype == jnp.int32
                   else jnp.asarray(rng.randn(*a.shape), a.dtype)),
        jcache.init_cache(JB.module.cache_specs(JB.reduced, 1, 32)))
    treq = convert.cache_from_jax(jax.tree.map(np.asarray, jreq))
    ids = np.asarray([8, 1, 6, 3], np.int32)
    jtree = jax.jit(JPagedKVCache(jp).scatter_request)(jtree, jreq,
                                                       jnp.asarray(ids))
    PagedKVCache(tp, "cpu").scatter_request(ttree, treq, ids)
    _assert_trees_equal(ttree, jtree)
