"""Self-healing paged serving on the port: the acceptance contract.

A DRAM row that turns weak at runtime (the chaos hook) is detected from
the per-page SECDED counts of the telemetry scrub, accused by the live
fault-map posterior and healed by an in-step page migration, while every
request stays bit-identical to its solo ``generate()`` replay on its
final placement and the decode-only step is built once.

The port's scheduler is stepped beside the reference's on converted
float32 weights (reduced llama3.2-3b, the four least reliable VCU128 PCs
at 0.91 V with ECC, read mode): every step's telemetry counters (exact),
suspect rows, quarantined pages and retired blocks, the migration pairs,
and the final tokens and page ids are equal.  The reference runs once per
module.  Port-only: replays, one decode trace, K4's launches per step
unchanged by healing, a host-read-free step body, the per-admission
governor (its voltages equal the reference's), an adaptive governor
re-planned from the posterior, the step counters, the guards, and
(``cuda``) the captured step equal to the eager one on the card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.domains import MemoryDomain as JDomain
from repro.core.hbm import VCU128 as JVCU128
from repro.models.base import get_arch as jget_arch
from repro.models.base import init_params as jinit_params
from repro.serving import engine as jserve
from repro.serving import scheduler as jsched
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core import pytree
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.hbm import VCU128
from repro_torch.kernels.flash_attention import faulty
from repro_torch.models.base import get_arch
from repro_torch.obs.metrics import N_STEP_COUNTERS, STEP_COUNTERS
from repro_torch.serving import captured
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request, SelfHealConfig)
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
JCFG = dataclasses.replace(JB.reduced, dtype=jnp.float32)
TCFG = dataclasses.replace(TB.reduced, dtype=torch.float32)
WORST_PCS = (8, 15, 18, 29)
ALL_PCS = tuple(range(32))

_R = np.random.RandomState(7)
REQS = [("a", _R.randint(0, TCFG.vocab, (5,)), 8, "cheap"),
        ("b", _R.randint(0, TCFG.vocab, (9,)), 10, "critical"),
        ("c", _R.randint(0, TCFG.vocab, (12,)), 12, "cheap")]
# block-sized pages (256 float32 slots: one 4096-word block per layer and
# page), so migrating off a weakened row drains whole blocks, which retire
_RB = np.random.RandomState(7)
BLOCK_REQS = [("x", _RB.randint(0, TCFG.vocab, (6,)), 6, "cheap"),
              ("y", _RB.randint(0, TCFG.vocab, (7,)), 6, "cheap")]
SCENARIOS = {
    "chaos": dict(reqs=REQS, max_len=32, page_slots=8, num_slots=4,
                  num_pages=16),
    "blocks": dict(reqs=BLOCK_REQS, max_len=256, page_slots=256,
                   num_slots=2, num_pages=10),
}
WEAKEN_AFTER = 2


@functools.lru_cache(maxsize=None)
def _weights():
    jp = jinit_params(JB.module.param_specs(JCFG), jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _plan(v=0.91, pcs=WORST_PCS, ecc=True, jax_side=False):
    dom = (JDomain if jax_side else MemoryDomain)("kv", v, pcs, ecc=ecc)
    return (JPlan if jax_side else UndervoltPlan)(
        domains={"kv": dom}, policy={"kv_cache": "kv"},
        geometry=JVCU128 if jax_side else VCU128)


def _sc(plan, max_len=32, **kw):
    kw.setdefault("max_new_tokens", 8)
    return ServeConfig(max_len=max_len, undervolt=plan, kv_injection="read",
                       kv_method="word", **kw)


def _port(scenario, device="cpu", heal=SelfHealConfig(), capture=True,
          params=None, num_pages=None, **kw):
    s = SCENARIOS[scenario]
    sched = ContinuousBatchingScheduler(
        TB, TCFG, params if params is not None else _weights()[1],
        _sc(_plan(), s["max_len"], **kw), num_slots=s["num_slots"],
        num_pages=num_pages or s["num_pages"], page_slots=s["page_slots"],
        device=device, self_heal=heal, capture=capture)
    for rid, toks, n, tier in s["reqs"]:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                             tier=tier))
    return sched


def _np(x):
    """A copy on the host of a jax array or a torch tensor on any device."""
    return x.cpu().numpy().copy() if torch.is_tensor(x) else np.array(x)


def _snapshot(sched, pool, suspects, retired, migrations):
    return dict(telem=_np(sched.state["telem"]).reshape(-1),
                telem_u=_np(sched.state["telem_u"]).reshape(-1),
                suspects=set(suspects),
                quarantined=tuple(pool.quarantined_pages),
                retired=set(retired), migrations=migrations)


def _drive(sched, snap, weaken=True):
    """admit / step until drained, weakening the first row of the first
    owned page after WEAKEN_AFTER steps; ``snap(sched)`` after each step.
    Returns the weakened (pc, row) and its page ids."""
    hit, out = None, []
    while sched.queue or sched.n_active:
        sched.admit_pending()
        if not sched.n_active:
            break
        if weaken and hit is None and sched.steps == WEAKEN_AFTER:
            pc, row = sched.pool.page_rows(sorted(sched.pool._owned)[0])[0]
            hit = (pc, row, sched.weaken_row(0, pc, row))
        sched.step_once()
        out.append(snap(sched))
    return hit, out


@functools.lru_cache(maxsize=None)
def _reference(scenario):
    """The reference's healing scheduler on the scenario, once per module:
    per-step snapshots, migration events, results."""
    s = SCENARIOS[scenario]
    sc = jserve.ServeConfig(max_len=s["max_len"], max_new_tokens=8,
                            undervolt=_plan(jax_side=True),
                            kv_injection="read", kv_method="word")
    js = jsched.ContinuousBatchingScheduler(
        JB, JCFG, _weights()[0], sc, num_slots=s["num_slots"],
        num_pages=s["num_pages"], page_slots=s["page_slots"],
        self_heal=jsched.SelfHealConfig())
    for rid, toks, n, tier in s["reqs"]:
        js.submit(jsched.Request(rid=rid, tokens=toks, max_new_tokens=n,
                                 tier=tier))

    def snap(j):
        sh = j._shards[0]
        return _snapshot(j, sh.pool, sh.suspects, sh.retired_blocks,
                         sh.migrations)

    hit, steps = _drive(js, snap)
    migs = [(e.step, e.data["src"], e.data["dst"])
            for e in js.trace.events("migration")]
    return dict(hit=hit, steps=steps, migs=migs, results=js.results,
                traces=len(js.traces), stats=js.stats)


def _port_snap(t):
    return _snapshot(t, t.pool, t.suspects, t.retired_blocks, t.migrations)


def _replays_equal(sched, reqs):
    for rid, toks, n, _ in reqs:
        ref = generate(TB, sched.cfg, sched.params, {"tokens": toks[None]},
                       dataclasses.replace(sched.sc, max_new_tokens=n),
                       device=sched.device,
                       kv_placement=sched.results[rid].placement)
        np.testing.assert_array_equal(ref.cpu().numpy(),
                                      sched.results[rid].tokens,
                                      err_msg=str(rid))


# ---------------------------------------------------------------------------
# in lockstep with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_selfheal_scheduler_steps_like_reference(scenario):
    """Every step: telemetry counters (exact), suspect rows, quarantined
    pages, retired blocks and migrations equal the reference's; then the
    migration pairs, tokens and page ids; each request == its solo replay
    on its final placement; one decode trace."""
    ref = _reference(scenario)
    t = _port(scenario)
    hit, steps = _drive(t, _port_snap)
    assert hit[:2] == ref["hit"][:2]
    np.testing.assert_array_equal(hit[2], ref["hit"][2])
    assert len(steps) == len(ref["steps"])
    for i, (got, want) in enumerate(zip(steps, ref["steps"])):
        for key in ("telem", "telem_u"):
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"step {i} {key}")
        for key in ("suspects", "quarantined", "retired", "migrations"):
            assert got[key] == want[key], (i, key)
    migs = [(e.step, e.data["src"], e.data["dst"])
            for e in t.trace.events("migration")]
    assert migs == ref["migs"] and migs
    for rid, *_ in SCENARIOS[scenario]["reqs"]:
        np.testing.assert_array_equal(t.results[rid].tokens,
                                      ref["results"][rid].tokens,
                                      err_msg=rid)
        np.testing.assert_array_equal(t.results[rid].page_ids,
                                      ref["results"][rid].page_ids)
    st, rst = t.stats, ref["stats"]
    for key in ("corrected", "uncorrectable", "migrations",
                "quarantined_pages", "quarantined_blocks"):
        assert st[key] == rst[key], key
    sh, rsh = st["shards"][0], rst["shards"][0]
    for key in ("tracked_rows", "suspect_rows", "migration_stalls",
                "free_pages", "voltage"):
        assert sh[key] == rsh[key], key
    assert st["decode_traces"] == ref["traces"] == 1
    assert sh["uncorrectable"] == 0 and sh["migrations"] >= 1
    quarantined = set(t.pool.quarantined_pages)
    assert quarantined & {int(p) for p in hit[2]}
    for rid, *_ in SCENARIOS[scenario]["reqs"]:
        assert not {int(p) for p in t.results[rid].page_ids} & quarantined
    if scenario == "blocks":
        retired = set(t.allocator.quarantined_blocks)
        assert retired and all(b[0] in WORST_PCS for b in retired)
        free = [p for p in range(t.pool.num_pages)
                if not t.pool.is_quarantined(p) and not t.pool.is_owned(p)]
        assert not retired & (t.pool.live_blocks()
                              | t.pool.page_blocks(free))
    _replays_equal(t, SCENARIOS[scenario]["reqs"])


# ---------------------------------------------------------------------------
# port-only invariants
# ---------------------------------------------------------------------------


class _NoHostRead(TorchDispatchMode):
    """Raises on what a CUDA graph cannot hold: a scalar read, a boolean
    mask index or a tensor made from host data."""

    _READS = {torch.ops.aten._local_scalar_dense.default,
              torch.ops.aten.nonzero.default,
              torch.ops.aten.lift_fresh.default}
    _INDEX = {torch.ops.aten.index.Tensor, torch.ops.aten.index_put.default,
              torch.ops.aten.index_put_.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self._READS:
            raise AssertionError(f"the step body calls {func}")
        if func in self._INDEX and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            raise AssertionError("the step body indexes with a mask")
        return func(*args, **(kwargs or {}))


def test_healing_step_body_reads_nothing_on_the_host_and_k4_is_flat(
        monkeypatch):
    """The decode-only body with migration, scrub and chaos reads nothing
    on the host; K4 runs once per layer and step with and without
    healing (the scrub is K2's count-only entry, one call per K/V leaf)."""
    orig = captured.CapturedStep.__call__

    def guarded(self):
        with _NoHostRead():
            return orig(self)

    monkeypatch.setattr(captured.CapturedStep, "__call__", guarded)
    k4, scrubs = [], []
    real_k4 = faulty.paged_decode_attention
    monkeypatch.setattr(faulty, "paged_decode_attention",
                        lambda *a, **k: k4.append(1) or real_k4(*a, **k))
    from repro_torch.serving import paged
    real_scrub = paged.ecc_page_events
    monkeypatch.setattr(paged, "ecc_page_events",
                        lambda *a, **k: scrubs.append(1)
                        or real_scrub(*a, **k))
    per_step = {}
    for heal in (None, SelfHealConfig()):
        k4.clear()
        scrubs.clear()
        t = _port("chaos", heal=heal)
        _drive(t, lambda s: None, weaken=heal is not None)
        assert t.stats["decode_traces"] == 1
        per_step[heal is not None] = (len(k4) / t.steps, len(scrubs),
                                      t.steps)
    assert per_step[True][0] == per_step[False][0] == TCFG.n_layers
    assert per_step[False][1] == 0
    assert per_step[True][1] == 2 * per_step[True][2]      # K and V leaves


def test_counters_track_selfheal_migrations():
    """pages_migrated counts exactly the committed in-step copies; the
    healing events land in the trace."""
    # free pages left over, and targets taken from the least reliable
    # end of the pool, so a free page under an accused row stays free
    t = _port("chaos", num_pages=24,
              heal=SelfHealConfig(migrate_tier="cheap"))
    want = np.zeros(N_STEP_COUNTERS, np.int64)
    hit = None
    while t.queue or t.n_active:
        t.admit_pending()
        if not t.n_active:
            break
        if hit is None and t.steps == WEAKEN_AFTER:
            # also a row that a live page shares with a free one: the
            # free page is quarantined outright once the row is accused
            p = t.pool
            shared = [r for q in sorted(p._owned) for r in p.page_rows(q)
                      if any(not p.is_owned(x) and not p.is_quarantined(x)
                             for x in p.pages_on_row(*r))]
            hit = [t.weaken_row(0, *r) for r in
                   (p.page_rows(sorted(p._owned)[0])[0], shared[0])]
        for g, rid in enumerate(t._slots):
            if rid is None:
                continue
            want[3] += t.pool.n_logical_pages
            if t._dec_h[g]:
                want[0] += 1
                want[2] += 1
            else:
                cur, plen = t._cursor_h[g], t._plen_h[g]
                end = min(cur + t.chunk, plen)
                want[1] += end - cur
                want[2] += max(0, end - max(cur, t._slot_plan[g].wstart0))
        m0 = t.migrations
        t.step_once()
        want[4] += t.migrations - m0
    got = t.metrics.counters_np(t.state).sum(axis=0)
    np.testing.assert_array_equal(got, want)
    assert t.migrations >= 1
    assert got[STEP_COUNTERS.index("pages_migrated")] == t.migrations
    ev = t.stats["events"]
    assert ev.get("migration", 0) == t.migrations
    assert ev.get("quarantine", 0) >= 1


def test_randomized_chaos_under_churn_monotone_and_replays():
    """Rows go weak at random times while six requests churn through two
    slots: quarantine only grows, no request fails, each equals its
    replay, one decode trace."""
    rng = np.random.RandomState(3)
    reqs = [(i, rng.randint(0, TCFG.vocab, (4 + i,)), 3 + (i % 3), "cheap")
            for i in range(6)]
    t = ContinuousBatchingScheduler(
        TB, TCFG, _weights()[1], _sc(_plan(), max_new_tokens=5),
        num_slots=2, num_pages=24, page_slots=8, device="cpu",
        self_heal=SelfHealConfig())
    for rid, toks, n, tier in reqs:
        t.submit(Request(rid=rid, tokens=toks, max_new_tokens=n, tier=tier))
    quar_prev, weakened = set(), 0
    while t.queue or t.n_active:
        t.admit_pending()
        if not t.n_active:
            break
        if t.steps in (2, 5):
            owned = sorted(t.pool._owned)
            pid = owned[rng.randint(len(owned))]
            pc, row = t.pool.page_rows(pid)[0]
            t.weaken_row(0, pc, row)
            weakened += 1
        t.step_once()
        quar = set(t.pool.quarantined_pages)
        assert quar >= quar_prev
        quar_prev = quar
    assert len(t.results) == 6 and weakened == 2
    assert t.stats["decode_traces"] == 1
    assert t.stats["quarantined_pages"] >= 1
    assert t.stats["shards"][0]["uncorrectable"] == 0
    _replays_equal(t, reqs)


@functools.lru_cache(maxsize=None)
def _reference_governed():
    jplan = _plan(0.91, ALL_PCS, ecc=False, jax_side=True)
    gov = jplan.make_governor("kv", mode="rate", tolerable_rate=1e-3,
                              v_lo=0.87)
    js = jsched.ContinuousBatchingScheduler(
        JB, JCFG, _weights()[0], jserve.ServeConfig(
            max_len=32, max_new_tokens=3, undervolt=jplan, governor=gov,
            kv_injection="read", kv_method="bitwise"),
        num_slots=4, num_pages=16, page_slots=8)
    for rid, toks, _, tier in REQS:
        js.submit(jsched.Request(rid=rid, tokens=toks, max_new_tokens=3,
                                 tier=tier))
    return js.run(), js.stats


def test_governor_replans_voltage_at_admission():
    """The per-admission governor walks the pool off its configured
    voltage with one decode trace; each admission's voltage and the
    tokens equal the reference's; the reference's constructor checks."""
    plan = _plan(0.91, ALL_PCS, ecc=False)
    gov = plan.make_governor("kv", mode="rate", tolerable_rate=1e-3,
                             v_lo=0.87)
    sc = ServeConfig(max_len=32, max_new_tokens=3, undervolt=plan,
                     governor=gov, kv_injection="read", kv_method="bitwise")
    t = ContinuousBatchingScheduler(TB, TCFG, _weights()[1], sc,
                                    num_slots=4, num_pages=16, page_slots=8,
                                    device="cpu")
    for rid, toks, _, tier in REQS:
        t.submit(Request(rid=rid, tokens=toks, max_new_tokens=3, tier=tier))
    res = t.run()
    jres, jstats = _reference_governed()
    assert t.stats["voltage"] != pytest.approx(0.91)
    assert t.stats["voltage"] == pytest.approx(jstats["voltage"])
    assert t.stats["decode_traces"] == 1
    for rid, *_ in REQS:
        assert res[rid].voltage == pytest.approx(jres[rid].voltage)
        np.testing.assert_array_equal(res[rid].tokens, jres[rid].tokens)
    fleet = t.stats["fleet"]
    assert fleet["shards"][0]["voltage"] == t.voltage
    kw = dict(num_slots=2, num_pages=8, page_slots=8, device="cpu")
    with pytest.raises(ValueError, match="kv_method='auto'"):
        ContinuousBatchingScheduler(TB, TCFG, _weights()[1],
                                    dataclasses.replace(sc, kv_method="auto"),
                                    **kw)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ContinuousBatchingScheduler(TB, TCFG, _weights()[1],
                                    dataclasses.replace(sc, kv_voltage=0.9),
                                    **kw)
    other = _plan(0.91, (0, 1), ecc=False)
    with pytest.raises(ValueError, match="built from sc.undervolt"):
        ContinuousBatchingScheduler(
            TB, TCFG, _weights()[1], dataclasses.replace(
                sc, governor=other.make_governor("kv")), **kw)


def test_adaptive_governor_replans_from_the_healing_posterior():
    """Under an adaptive governor, a moving suspect set re-plans the
    frontier and emits a replan event; the step is still built once."""
    plan = _plan(0.91, WORST_PCS[:1])
    gov = plan.make_governor("kv", mode="adaptive", tolerable_rate=1.0,
                             v_hi=0.91, v_lo=0.89)
    t = ContinuousBatchingScheduler(
        TB, TCFG, _weights()[1], _sc(plan, max_new_tokens=16, governor=gov),
        num_slots=4, num_pages=16, page_slots=8, device="cpu",
        self_heal=SelfHealConfig())
    t.submit(Request(rid="r1", tokens=REQS[0][1], max_new_tokens=16))
    hit, _ = _drive(t, lambda s: None)
    st = t.stats
    assert hit is not None and len(t.results) == 1
    assert st["shards"][0]["governor_replans"] == gov.replans >= 1
    assert st["events"]["replan"] == gov.replans
    assert st["decode_traces"] == 1 and "fleet" in st


def test_self_heal_config_and_weaken_row_validation():
    with pytest.raises(ValueError, match="ECC"):
        ContinuousBatchingScheduler(
            TB, TCFG, _weights()[1], _sc(_plan(ecc=False)), num_slots=2,
            num_pages=8, page_slots=8, device="cpu",
            self_heal=SelfHealConfig())
    with pytest.raises(ValueError, match="read"):
        ContinuousBatchingScheduler(
            TB, TCFG, _weights()[1], dataclasses.replace(
                _sc(_plan()), kv_injection="write"), num_slots=2,
            num_pages=8, page_slots=8, device="cpu",
            self_heal=SelfHealConfig())
    with pytest.raises(ValueError, match="max_migrations"):
        _port("chaos", heal=SelfHealConfig(max_migrations=0))
    with pytest.raises(ValueError, match="self_heal"):
        _port("chaos", heal=None).weaken_row(0, WORST_PCS[0], 0)
    with pytest.raises(ValueError, match="out of range"):
        _port("chaos").weaken_row(1, WORST_PCS[0], 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_captured_healing_step_equals_eager_on_card(cuda_device):
    """The chaos scenario on the card, captured and eager: equal tokens,
    pool words, per-step telemetry, migration pairs and quarantine set;
    one trace; each request == its replay on the card."""
    params = pytree.tree_map(lambda x: x.to(cuda_device), _weights()[1])
    runs = []
    for capture in (True, False):
        t = _port("chaos", device=cuda_device, capture=capture,
                  params=params)
        _, steps = _drive(t, _port_snap)
        runs.append((t, steps))
    (a, sa), (b, sb) = runs
    assert a.stats["decode_traces"] == b.stats["decode_traces"] == 1
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        for key in ("telem", "telem_u"):
            np.testing.assert_array_equal(x[key], y[key])
        assert x["quarantined"] == y["quarantined"]
    assert ([(e.step, e.data["src"], e.data["dst"])
             for e in a.trace.events("migration")]
            == [(e.step, e.data["src"], e.data["dst"])
                for e in b.trace.events("migration")])
    assert a.migrations >= 1
    for x, y in zip(pytree.leaves(a.state["pool"]),
                    pytree.leaves(b.state["pool"])):
        assert torch.equal(x.view(torch.int32) if x.element_size() == 4
                           else x.view(torch.int16),
                           y.view(torch.int32) if y.element_size() == 4
                           else y.view(torch.int16))
    for rid, *_ in REQS:
        np.testing.assert_array_equal(a.results[rid].tokens,
                                      b.results[rid].tokens)
    _replays_equal(a, REQS)
