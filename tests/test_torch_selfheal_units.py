"""The port's self-healing building blocks held against the JAX reference.

The fault-map posterior (the per-call ``observe`` and the port's
vectorised fold of a whole step), the adaptive governor's re-plan, the
allocator's free / quarantine / adopt guards, the pool's page -> row and
page -> block maps with quarantine and migration accounting, and the
device paths of one healing step: ``ecc_event_counts``, the telemetry
scrub (K2's count-only entry's plain version, with and without the chaos
hook) and the in-step page copy -- integers bit for bit on the same raw
words, beliefs and rates within 1e-6.  The reference's regime: reduced
llama3.2-3b pools on the four least reliable VCU128 PCs at 0.91 V with
ECC.  The ``cuda`` tests hold K2's count-only kernel to its plain
version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.domains import DomainAllocator as JAllocator
from repro.core.domains import MemoryDomain as JDomain
from repro.core.faultmap_posterior import FaultMapPosterior as JPosterior
from repro.core.hbm import VCU128 as JVCU128
from repro.models import cache as jcache
from repro.models.base import get_arch as jget_arch
from repro.serving.paged import PagedKVCache as JPagedKVCache
from repro.serving.paged import PagePool as JPagePool
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core import hashing as H
from repro_torch.core import pytree
from repro_torch.core.domains import DomainAllocator, MemoryDomain
from repro_torch.core.faultmap_posterior import FaultMapPosterior
from repro_torch.core.hbm import VCU128
from repro_torch.kernels import _build
from repro_torch.kernels.ecc import ecc as ecc_mod
from repro_torch.models.base import get_arch
from repro_torch.serving.paged import PagedKVCache, PagePool
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


JB, TB = jget_arch("llama3.2-3b"), get_arch("llama3.2-3b")
# The reference tests' regime: the four least reliable VCU128 PCs, where
# weak rows throw correctable SECDED events at 0.91 V.
WORST_PCS = (8, 15, 18, 29)
# Beliefs and rates: float32 LLRs summed in float64 in both packages, the
# logs of numpy and XLA may differ in the last float32 bit.
TOL = 1e-6


def _plans(v=0.91, pcs=WORST_PCS, ecc=True):
    kw = dict(policy={"kv_cache": "kv"})
    return (JPlan(domains={"kv": JDomain("kv", v, pcs, ecc=ecc)},
                  geometry=JVCU128, **kw),
            UndervoltPlan(domains={"kv": MemoryDomain("kv", v, pcs, ecc=ecc)},
                          geometry=VCU128, **kw))


def _pools(num_pages=16, page_slots=8, max_len=32, v=0.91):
    jplan, tplan = _plans(v)
    kw = dict(max_len=max_len, page_slots=page_slots, num_pages=num_pages)
    return (JPagePool(JB.module, JB.reduced, plan=jplan, **kw),
            PagePool(TB.module, TB.reduced, plan=tplan, **kw))


# ---------------------------------------------------------------------------
# the fault-map posterior
# ---------------------------------------------------------------------------


def _stream(fmap, steps, seed):
    """Steps of observations, each step at one voltage (as the scheduler
    folds them): rows of the domain's PCs, weak and strong, with repeats
    inside a step; some observations carry no codewords (no-ops)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        n = rng.randint(1, 40)
        pcs = rng.choice(WORST_PCS, n)
        rows = np.empty(n, np.int64)
        for i, pc in enumerate(pcs):
            weak = np.flatnonzero(fmap.weak_row_mask(int(pc)))
            rows[i] = (weak[rng.randint(len(weak))] if rng.rand() < 0.4
                       else rng.randint(0, 64))
        corr = rng.poisson(1.5, n) * (rng.rand(n) < 0.6)
        bad = rng.poisson(0.3, n) * (rng.rand(n) < 0.2)
        cw = rng.choice([0, 64, 128, 4096], n, p=[0.05, 0.35, 0.3, 0.3])
        out.append((float(rng.choice([0.91, 0.90, 0.93])),
                    (pcs, rows, corr, bad, cw)))
    return out


def test_posterior_matches_reference_and_fold_matches_loop():
    """The same observation stream gives the reference's tracked rows,
    suspect sets, p_weak and predicted rates; folding each step's batch
    in one call leaves exactly (bits) the per-call loop's beliefs."""
    jplan, tplan = _plans()
    jpost = JPosterior(jplan.fault_map())
    loop = FaultMapPosterior(tplan.fault_map())
    fold = FaultMapPosterior(tplan.fault_map())
    for v, cols in _stream(tplan.fault_map(), 30, 3):
        for pc, row, c, u, n in zip(*(a.tolist() for a in cols)):
            kw = dict(corrected=c, codewords=n, voltage=v, uncorrectable=u)
            jpost.observe(pc, row, **kw)
            loop.observe(pc, row, **kw)
        fold.observe_many(*cols, v)
    assert loop.tracked_rows == tuple(sorted(jpost._rows))
    assert loop.stats() == jpost.stats()
    assert fold.tracked_rows == loop.tracked_rows
    assert fold.stats() == loop.stats()
    for name in ("_llr", "_corrected", "_uncorrectable", "_codewords"):
        np.testing.assert_array_equal(getattr(fold, name),
                                      getattr(loop, name))
    for pc, row in loop.tracked_rows[::5] + ((8, 5000), (29, 1)):
        assert abs(loop.p_weak(pc, row) - jpost.p_weak(pc, row)) < TOL
    for v in (0.89, 0.91, 0.95, 0.98):
        for thr in (0.5, 0.9):
            assert loop.suspect_rows(v, thr) == jpost.suspect_rows(v, thr)
        np.testing.assert_allclose(loop.predicted_rates(v),
                                   jpost.predicted_rates(v), rtol=0,
                                   atol=TOL)
    assert loop.suspect_rows(0.91) and loop.suspect_rows(0.98) == []


def test_posterior_accuses_and_absolves_rows():
    """The reference's unit contract, on the port."""
    fmap = _plans()[1].fault_map()
    post = FaultMapPosterior(fmap)
    pc = WORST_PCS[-1]
    weak_rows = np.flatnonzero(fmap.weak_row_mask(pc))
    strong_rows = np.flatnonzero(~fmap.weak_row_mask(pc))
    wr, sr = int(weak_rows[0]), int(strong_rows[0])
    assert post.p_weak(pc, sr) == pytest.approx(1e-3, rel=0.01)
    assert post.p_weak(pc, wr) == pytest.approx(1.0, abs=1e-3)
    for _ in range(3):
        post.observe(pc, sr, corrected=4, codewords=128, voltage=0.91)
    assert post.p_weak(pc, sr) > 0.9
    assert (pc, sr) in post.suspect_rows(0.91)
    assert post.suspect_rows(0.98) == []
    post.observe(pc, wr, corrected=0, codewords=5000, voltage=0.91)
    assert post.p_weak(pc, wr) < 0.9
    for _ in range(2):
        post.observe(pc, sr + 1, corrected=0, uncorrectable=4,
                     codewords=128, voltage=0.91)
    assert post.p_weak(pc, sr + 1) > 0.9
    assert post.predicted_rates(0.91)[pc] > fmap.pc_total_rate(0.91)[pc]
    n_rows = len(post.tracked_rows)
    post.observe(pc, sr + 2, corrected=9, codewords=0, voltage=0.91)
    assert len(post.tracked_rows) == n_rows
    s = post.stats()
    assert s["tracked_rows"] == n_rows and s["corrected"] == 12


# ---------------------------------------------------------------------------
# the adaptive governor
# ---------------------------------------------------------------------------


def test_adaptive_governor_replans_like_reference():
    jplan, tplan = _plans()
    kw = dict(mode="adaptive", tolerable_rate=1.0, v_hi=0.93, v_lo=0.91)
    jg, tg = jplan.make_governor("kv", **kw), tplan.make_governor("kv", **kw)
    jpost = JPosterior(jplan.fault_map())
    tpost = FaultMapPosterior(tplan.fault_map())
    s = tg.rate_at(0.91) * 1.00002
    assert tg.voltage_at(s) == pytest.approx(float(jg.voltage_at(s)))
    for row in range(200, 208):
        for _ in range(3):
            for post in (jpost, tpost):
                post.observe(29, row, corrected=4, codewords=128,
                             voltage=0.91)
    jg.replan(jpost)
    tg.replan(tpost)
    assert tg.replans == jg.replans == 1
    for v in (0.91, 0.915, 0.92, 0.93):
        assert abs(tg.rate_at(v) - jg.rate_at(v)) <= TOL * jg.rate_at(v)
    for sp in (s, tg.rate_at(0.92), 1e-9, 1.0):
        assert tg.voltage_at(sp) == pytest.approx(float(jg.voltage_at(sp)),
                                                  abs=TOL)
    assert tg.rate_at(0.91) > s and tg.voltage_at(s) > 0.91
    with pytest.raises(ValueError, match="adaptive"):
        tplan.make_governor("kv", mode="rate").replan(tpost)


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------


def _segs(segments):
    """Segments of either package as plain tuples."""
    return [(g.leaf_start_word, g.n_words, g.pc, g.phys_base_word)
            for g in segments]


def test_allocator_rejects_freeing_blocks_backing_live_pages():
    """The reference test's guards, plus recycling in the reference's
    order after an adopt and a free."""
    jp, tp = _pools(num_pages=8)
    alloc = DomainAllocator(VCU128, tp.domain, tp.faultmap)
    alloc.adopt(tp.placement)
    alloc.register_pool(tp)
    pids = tp.alloc(2, "cheap")
    segs = tp.placement.leaves[0].segments
    with pytest.raises(ValueError, match="live pages"):
        alloc.free(segs)
    with pytest.raises(ValueError, match="live pages"):
        alloc.quarantine(segs)
    tp.free(pids)
    alloc.quarantine(segs)
    assert alloc.quarantined_blocks
    with pytest.raises(ValueError, match="not currently allocated"):
        alloc.free(segs)
    with pytest.raises(ValueError, match="not currently allocated"):
        alloc.quarantine(segs)
    with pytest.raises(ValueError, match="fresh allocator"):
        alloc.adopt(tp.placement)
    # the same sequence on the reference's allocator: same retired blocks,
    # and the next allocations recycle the same blocks
    ja = JAllocator(JVCU128, jp.domain, jp.faultmap)
    ja.adopt(jp.placement)
    ja.quarantine(jp.placement.leaves[0].segments)
    assert alloc.quarantined_blocks == ja.quarantined_blocks
    other = tp.placement.leaves[1].segments
    alloc.free(other)
    ja.free(jp.placement.leaves[1].segments)
    for n_words in (4096, 3 * 4096 + 5):
        assert _segs(alloc.alloc(n_words)) == _segs(ja.alloc(n_words))
    assert alloc.free_words == ja.free_words


# ---------------------------------------------------------------------------
# the pool's maps, quarantine and migration accounting
# ---------------------------------------------------------------------------


def test_pool_maps_quarantine_and_migrate_match_reference():
    jp, tp = _pools(num_pages=16)
    assert tp.page_codewords() == jp.page_codewords()
    for pid in range(tp.total_pages):
        assert tp.page_rows(pid) == jp.page_rows(pid)
    rows = sorted({r for pid in range(tp.total_pages)
                   for r in jp.page_rows(pid)})
    for pc, row in rows + [(WORST_PCS[0], 10 ** 5)]:
        np.testing.assert_array_equal(tp.pages_on_row(pc, row),
                                      jp.pages_on_row(pc, row))
    ids = [0, 3, 7, tp.scratch_id]
    assert tp.page_blocks(ids) == jp.page_blocks(ids)
    for p in (jp, tp):
        a = p.alloc(4, "cheap")
        p.share(a[:1], ("__req__", "x"))
        p.quarantine([int(x) for x in p._strong[:2]] + p._weak[:1])
        p.migrate(int(a[1]), int(p.alloc(1, "cheap")[0]))
        p.migrate(int(a[0]), int(p.alloc(1, "cheap")[0]))
        with pytest.raises(ValueError, match="freshly allocated"):
            p.migrate(int(a[2]), int(a[0]))     # a PageSharingError
        with pytest.raises(ValueError, match="not allocated"):
            p.migrate(int(a[1]), int(p.alloc(1, "cheap")[0]))
    assert tp.quarantined_pages == jp.quarantined_pages
    assert tp._owned == jp._owned and tp._shared == jp._shared
    assert (tp._strong, tp._weak) == (jp._strong, jp._weak)
    assert tp.live_blocks() == jp.live_blocks()
    assert _segs(tp.retirable_blocks()) == _segs(jp.retirable_blocks())
    tp.free(sorted(q for q in tp._owned if q not in tp._shared))
    jp.free(sorted(q for q in jp._owned if q not in jp._shared))
    assert _segs(tp.retirable_blocks()) == _segs(jp.retirable_blocks())
    events = []
    tp.on_event = lambda kind, **kw: events.append((kind, kw))
    tp.quarantine(tp.quarantined_pages)          # replayed: no event
    assert events == []
    nxt = tp._strong[0]
    tp.quarantine([nxt])
    assert events == [("quarantine", {"pages": [nxt]})]
    assert tp.is_quarantined(nxt) and nxt not in tp._strong


# ---------------------------------------------------------------------------
# device paths of a healing step: raw words, bit for bit
# ---------------------------------------------------------------------------


def _pool_trees(jp, seed):
    rng = np.random.RandomState(seed)

    def fill(a):
        if a.dtype == jnp.int32:
            return jnp.asarray(rng.randint(0, 32, a.shape), jnp.int32)
        return jnp.asarray(rng.randn(*a.shape), a.dtype)
    jtree = jax.tree.map(fill, jcache.init_cache(jp.pool_specs))
    return jtree, convert.cache_from_jax(jax.tree.map(np.asarray, jtree))


def _bits_equal(ttree, jtree):
    jflat = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}
    for p, t in pytree.flatten_with_path(ttree):
        j = jflat[pytree.keystr(p)]
        np.testing.assert_array_equal(
            convert.tensor_to_numpy_bits(t),
            j.view({2: np.uint16, 4: np.uint32}[j.dtype.itemsize]),
            err_msg=pytree.keystr(p))


@pytest.mark.parametrize("v", [0.91, 0.86])
def test_ecc_event_counts_bit_exact(v):
    """``ecc_event_counts`` on the same raw words and tables, at page
    granularity (the scrub's) and at block granularity."""
    rng = np.random.RandomState(4)
    jplan, tplan = _plans(v)
    jtab = jplan.fault_map().threshold_table(v)
    ttab = tplan.fault_map().threshold_table(v)
    words = rng.randint(0, 2 ** 32, (8, 512), dtype=np.uint64).astype(
        np.uint32)
    pcs = np.asarray([8, 15, 18, 29, 8, 29, 15, 18])
    base = (pcs * (VCU128.bytes_per_pc // 4)
            + rng.randint(0, 4096, 8) * 4096).astype(np.uint32)
    off = np.arange(8 * 512, dtype=np.uint32).reshape(8, 512)
    counts = 0
    for lg2 in (9, 12):
        nb = 8 * 512 >> lg2
        jc, ju = jengine.ecc_event_counts(
            jnp.asarray(words), jnp.asarray(off), jnp.asarray(base[:nb]),
            jtab[jnp.asarray(pcs[:nb])], seed=jplan.map_seed,
            words_per_row_log2=jplan.fault_map().words_per_row_log2,
            words_log2=lg2)
        tc, tu = engine.ecc_event_counts(
            H.as_i32(torch.from_numpy(words.astype(np.int64))),
            torch.from_numpy(off.astype(np.int64)),
            H.as_i32(torch.from_numpy(base[:nb].astype(np.int64))),
            ttab[torch.from_numpy(pcs[:nb])], seed=tplan.map_seed,
            words_per_row_log2=tplan.fault_map().words_per_row_log2,
            words_log2=lg2)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        counts += int(tc.sum()) + int(tu.sum())
    if v < 0.9:
        assert counts > 0


@pytest.mark.parametrize("v,chaos", [(0.91, False), (0.91, True),
                                     (0.86, False)])
def test_scrub_telemetry_and_migrate_pages_bit_exact(v, chaos):
    """The telemetry scrub (with and without the chaos override) and the
    in-step page copy on the same pool words, with a page table that
    references some pages twice and the scratch page."""
    jp, tp = _pools(num_pages=12, v=v)
    jk, tk = JPagedKVCache(jp), PagedKVCache(tp, "cpu")
    jtree, ttree = _pool_trees(jp, 5)
    ptab = np.asarray([[3, 5, 7, 9], [0, 1, 2, 4],
                       [tp.scratch_id] * 4, [11, 3, 6, 6]], np.int32)
    mask = np.zeros(tp.total_pages, bool)
    if chaos:
        mask[[1, 3, 8]] = True
    jc, ju = jax.jit(jk.scrub_telemetry)(
        jtree, jnp.asarray(ptab), jnp.float32(v),
        chaos=jnp.asarray(mask) if chaos else None)
    tc, tu = tk.scrub_telemetry(ttree, torch.from_numpy(ptab), v,
                                chaos=torch.from_numpy(mask) if chaos
                                else None)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    assert tc.dtype == torch.int32 and int(tc[tp.scratch_id]) == 0
    assert int(tc[8]) == int(tu[8]) == 0             # 8: not referenced
    if v < 0.9 or chaos:
        assert int(tc.sum()) > 0
    if chaos:
        plain, _ = tk.scrub_telemetry(ttree, torch.from_numpy(ptab), v)
        assert int(tc.sum()) > int(plain.sum())
    src = np.asarray([3, 0, tp.scratch_id, tp.scratch_id], np.int32)
    dst = np.asarray([10, 8, tp.scratch_id, tp.scratch_id], np.int32)
    jtree = jax.jit(jk.migrate_pages)(jtree, jnp.asarray(src),
                                      jnp.asarray(dst))
    tk.migrate_pages(ttree, torch.from_numpy(src), torch.from_numpy(dst))
    _bits_equal(ttree, jtree)


def test_chaos_context_weakens_only_marked_pages():
    """``make_ctx(chaos=)``: marked pages read through the weak columns,
    as the reference's context; others keep the voltage's tables."""
    jp, tp = _pools(num_pages=8)
    tk, jk = PagedKVCache(tp, "cpu"), JPagedKVCache(jp)
    mask = np.zeros(tp.total_pages, bool)
    mask[[2, 5]] = True
    ptab = jnp.zeros((2, 4), jnp.int32)
    jctx = jk.make_ctx(ptab, jnp.float32(0.91), method="word", inject=True,
                       chaos=jnp.asarray(mask))
    tctx = tk.make_ctx(torch.zeros((2, 4), dtype=torch.int32), 0.91,
                       method="word", inject=True, chaos=mask)
    plain = tk.make_ctx(torch.zeros((2, 4), dtype=torch.int32), 0.91,
                        method="word", inject=True)
    for key, je in jctx.entries.items():
        for half in ("k", "v"):
            jthr = np.asarray(getattr(je, half).thr).view(np.int32)
            tthr = getattr(tctx.entries[key], half).thr.numpy()
            np.testing.assert_array_equal(tthr, jthr)
            pthr = getattr(plain.entries[key], half).thr.numpy()
            np.testing.assert_array_equal(tthr[:, ~mask], pthr[:, ~mask])
            assert (tthr[:, mask] != pthr[:, mask]).any()


def test_static_tables_follow_voltage_and_chaos_in_place():
    """A scheduler's static tables: rewritten in place (same storage) to
    another voltage and to chaos marks, equal to the fresh tables."""
    _, tp = _pools(num_pages=8)
    tk = PagedKVCache(tp, "cpu")
    st = tk.static_tables(0.91)
    ptrs = [e.thr.data_ptr() for s in st.ctx.values() for e in (s.k, s.v)]
    mask = np.zeros(tp.total_pages, bool)
    mask[3] = True
    for v, chaos in ((0.88, None), (0.91, mask), (0.88, mask)):
        tk.load_tables(st, v, chaos)
        want = tk.tables(v, chaos)
        for key, e in st.ctx.items():
            for half in ("k", "v"):
                assert torch.equal(getattr(e, half).thr,
                                   getattr(want.ctx[key], half).thr)
        for path, (bb, bt) in st.write.items():
            assert torch.equal(bt, want.write[path][1])
    assert ptrs == [e.thr.data_ptr() for s in st.ctx.values()
                    for e in (s.k, s.v)]


# ---------------------------------------------------------------------------
# K2's count-only entry on the card
# ---------------------------------------------------------------------------


def _scrub_operands(dev, n_layers=3, total_pages=37, page_words=512,
                    seed=0):
    g = torch.Generator().manual_seed(seed)
    _, tplan = _plans(0.87)
    fmap = tplan.fault_map()
    words = torch.randint(-2 ** 31, 2 ** 31 - 1,
                          (n_layers, total_pages, page_words), generator=g,
                          dtype=torch.int32)
    pcs = torch.tensor(WORST_PCS)[torch.randint(0, 4, (n_layers,
                                                       total_pages),
                                                generator=g)]
    base = H.as_i32(pcs * (VCU128.bytes_per_pc // 4)
                    + torch.randint(0, 2 ** 14, pcs.shape, generator=g)
                    * page_words)
    thr = fmap.threshold_table(0.87)[pcs]
    ref = torch.rand(total_pages, generator=g) < 0.7
    kw = dict(seed=fmap.seed, words_per_row_log2=fmap.words_per_row_log2)
    return [t.to(dev) for t in (words, base, thr, ref)], kw


def test_ecc_page_events_plain_counts():
    """The plain version equals a per-page count with
    ``ecc_event_counts`` over each (layer, page) slice, masked."""
    (words, base, thr, ref), kw = _scrub_operands("cpu")
    corr, bad = ecc_mod.ecc_page_events(words, base, thr, ref, **kw)
    for p in (0, 5, 36):
        c = u = 0
        for l in range(words.shape[0]):
            cc, uu = engine.ecc_event_counts(
                words[l, p], torch.arange(512), base[l, p:p + 1],
                thr[l, p:p + 1], words_log2=9, **kw)
            c, u = c + int(cc.sum()), u + int(uu.sum())
        assert (int(corr[p]), int(bad[p])) == ((c, u) if ref[p] else (0, 0))
    assert int(corr.sum()) > 0 and int(bad.sum()) > 0


@pytest.mark.cuda
def test_ecc_page_events_kernel_equals_plain_on_card(cuda_device):
    for n_layers, tp, pw in ((3, 37, 512), (2, 9, 4096), (28, 5, 64)):
        ops, kw = _scrub_operands(cuda_device, n_layers, tp, pw)
        _build.reset_launch_counts()
        got = ecc_mod.ecc_page_events(*ops, **kw)
        assert _build.launch_counts()["arena_ecc_events"] == 1
        want = ecc_mod.ecc_page_events_ref(*ops, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(want[0].sum()) > 0
