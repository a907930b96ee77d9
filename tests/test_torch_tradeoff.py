"""The port's trade-off frontier, solver and voltage governor held against
the JAX reference, and ``generate()`` under the admission governor.

The frontier is float32 in both packages and the governor's choices turn
on its comparisons, so every field is compared on bits (0 ulp) on the
paper's 40-point grid and a 5 mV grid, for the paper's map and three
other seeds.  The solver's answers to the paper's worked examples, the
Fig. 6 matrix and the Pareto frontier are compared as values; the
governor's ``voltage_at`` and ``admit`` over grids of setpoints and byte
counts, including the generate() cell's 448 MiB on its 16-PC plan.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tradeoff as jtradeoff
from repro.core.domains import CapacityError as JCapacityError
from repro.core.domains import MemoryDomain as JDomain
from repro.core.faultmap import PAPER_MAP_SEED
from repro.core.faultmap import FaultMap as JFaultMap
from repro.core.hbm import VCU128 as JVCU128
from repro.models.base import get_arch as jget_arch
from repro.models.base import init_params as jinit_params
from repro.training import governor as jgovernor
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core import tradeoff
from repro_torch.core.domains import CapacityError, MemoryDomain
from repro_torch.core.faultmap import FaultMap
from repro_torch.core.hbm import VCU128
from repro_torch.models.base import get_arch
from repro_torch.serving import engine as tserve
from repro_torch.training import governor
from repro_torch.training.undervolt import UndervoltPlan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JMAP = JFaultMap.from_seed(JVCU128, seed=PAPER_MAP_SEED)
TMAP = FaultMap.from_seed(VCU128, seed=PAPER_MAP_SEED)
JSOLVER, TSOLVER = jtradeoff.TradeoffSolver(JMAP), tradeoff.TradeoffSolver(TMAP)
FIELDS = ("voltages", "savings", "power", "pc_rate", "pc_order", "usable",
          "num_usable", "worst_rate", "mean_rate")
TOLERANCES = (0.0, 1e-8, 1e-6, 1e-4, 1e-2, 0.5)


def test_voltage_grid_equal():
    for args in ((), (0.98, 0.86, 0.01), (1.0, 0.9, 0.005)):
        np.testing.assert_array_equal(tradeoff.voltage_grid(*args),
                                      jtradeoff.voltage_grid(*args))


@pytest.mark.parametrize("seed", [PAPER_MAP_SEED, 1, 77, 12345])
def test_frontier_bit_equal(seed):
    """Every field on bits: usable / num_usable / pc_order exactly (the
    governor's choices depend on them), the float fields at 0 ulp."""
    jsolver = jtradeoff.TradeoffSolver(JFaultMap.from_seed(JVCU128, seed))
    tsolver = tradeoff.TradeoffSolver(FaultMap.from_seed(VCU128, seed))
    for grid in (jtradeoff.voltage_grid(),
                 np.round(np.arange(0.80, 1.2, 0.005), 4)):
        for tol in TOLERANCES:
            ref, got = jsolver.frontier(grid, tol), tsolver.frontier(grid, tol)
            for f in FIELDS:
                np.testing.assert_array_equal(
                    getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                    err_msg=f"{f} tol={tol}")
            np.testing.assert_array_equal(got.capacity_bytes.numpy(),
                                          np.asarray(ref.capacity_bytes))


def test_solver_matches_reference_on_papers_examples():
    for req, tol in ((JVCU128.total_bytes, 0.0),
                     (7 * JVCU128.bytes_per_pc, 0.0),
                     (JVCU128.total_bytes // 2, 1e-6),
                     (JVCU128.bytes_per_pc, 1e-3)):
        got, ref = TSOLVER.solve(req, tol), JSOLVER.solve(req, tol)
        assert dataclasses.astuple(got) == dataclasses.astuple(ref)
    # the paper's anchors, as the reference's own tests pin them
    p = TSOLVER.solve(VCU128.total_bytes, 0.0)
    assert (p.voltage, len(p.pc_ids)) == (pytest.approx(0.98), 32)
    assert p.savings == pytest.approx(1.5, abs=0.01)
    assert TSOLVER.solve(7 * VCU128.bytes_per_pc, 0.0).voltage == (
        pytest.approx(0.95))
    assert TSOLVER.solve(VCU128.total_bytes // 2, 1e-6).savings == (
        pytest.approx(1.8, abs=0.1))
    f = TSOLVER.frontier(np.asarray([0.85]), 0.5)
    assert float(f.savings[0]) == pytest.approx(2.3, abs=0.06)
    for args in ((0.85, 0.5, VCU128.bytes_per_pc), (0.90, 1e-6, 0),
                 (0.95, 0.0, 7 * VCU128.bytes_per_pc)):
        got, ref = TSOLVER.point(*args), JSOLVER.point(*args)
        assert (got is None and ref is None) or (
            dataclasses.astuple(got) == dataclasses.astuple(ref))
        o, jo = tradeoff.oracle_point(TMAP, *args), jtradeoff.oracle_point(
            JMAP, *args)
        assert (o is None and jo is None) or (
            dataclasses.astuple(o) == dataclasses.astuple(jo))
    with pytest.raises(ValueError, match="no feasible"):
        TSOLVER.solve(VCU128.total_bytes * 2, 0.0)


def test_fig6_matrix_and_pareto_match_reference():
    rates = [0.0, 1e-7, 1e-5, 1e-3]
    assert TSOLVER.fig6_matrix(rates) == JSOLVER.fig6_matrix(rates)
    for tol in (1e-6, 1e-3):
        got, ref = TSOLVER.pareto(tol), JSOLVER.pareto(tol)
        assert [dataclasses.astuple(p) for p in got] == [
            dataclasses.astuple(p) for p in ref]


# ---- the governor ---------------------------------------------------------

def _plans(v=0.91, pcs=None, ecc=False):
    """The generate() cell's plan: the 16 most reliable PCs at v."""
    if pcs is None:
        pcs = tuple(int(p) for p in TMAP.usable_pcs(v, 1.0))[:16]
    return (JPlan(domains={"kv": JDomain("kv", v, pcs, ecc=ecc)},
                  policy={"kv_cache": "kv"}, geometry=JVCU128,
                  map_seed=PAPER_MAP_SEED),
            UndervoltPlan(domains={"kv": MemoryDomain("kv", v, pcs, ecc=ecc)},
                          policy={"kv_cache": "kv"}, geometry=VCU128,
                          map_seed=PAPER_MAP_SEED))


CELL_KV_BYTES = 448 << 20


def _outcome(fn):
    try:
        return float(fn())
    except (CapacityError, JCapacityError) as e:
        return type(e).__name__


@pytest.mark.parametrize("mode", ["rate", "power", "efficiency"])
def test_governor_walks_match_reference(mode):
    jplan, tplan = _plans()
    for tol, req in ((1e-6, 0), (1e-3, 2 * VCU128.bytes_per_pc), (1.0, 0)):
        kw = dict(mode=mode, tolerable_rate=tol, required_bytes=req)
        jg, tg = jplan.make_governor("kv", **kw), tplan.make_governor(
            "kv", **kw)
        # boundaries: every grid rate and power, and just either side
        edges = np.concatenate([np.asarray(jg._rate_np, np.float64),
                                np.asarray(jg._power_np, np.float64)])
        sps = np.concatenate([[1e-9, 1e-7, 1e-5, 1e-3, 0.1, 0.5, 0.7, 0.9,
                               1.0, 1.5], edges, edges * (1 + 1e-6),
                              edges * (1 - 1e-6)])
        for sp in sps:
            assert tg.voltage_at(sp) == float(jg.voltage_at(sp)), (tol, sp)
            for nbytes in (0, CELL_KV_BYTES, 5 * VCU128.bytes_per_pc,
                           17 * VCU128.bytes_per_pc):
                assert (_outcome(lambda: tg.admit(nbytes, sp))
                        == _outcome(lambda: jg.admit(nbytes, sp))), (
                            tol, sp, nbytes)
        for nbytes in (0, CELL_KV_BYTES):
            assert (_outcome(lambda: tg.admit(nbytes))
                    == _outcome(lambda: jg.admit(nbytes)))
        assert tg.override() == {"kv": float(jg.override()["kv"])}
        for v in (0.86, 0.875, 0.9, 0.93, 0.98):
            assert tg.power_at(v) == jg.power_at(v)
            assert tg.rate_at(v) == jg.rate_at(v)
            assert tg.efficiency_at(v) == jg.efficiency_at(v)


def test_generate_cell_admission_matches_reference():
    """The choice the full-width generate() cell is served at: 448 MiB
    on its 16-PC plan (chip_smoke.py's governor phase) is admitted at
    the same voltage, below the guardband, in both packages."""
    jplan, tplan = _plans()
    jg = jplan.make_governor("kv", mode="rate", tolerable_rate=1e-6)
    tg = tplan.make_governor("kv", mode="rate", tolerable_rate=1e-6)
    v = tg.admit(CELL_KV_BYTES)
    assert v == jg.admit(CELL_KV_BYTES)
    assert 0.88 < v < 0.91


def test_fleet_report_matches_reference():
    jplan, tplan = _plans()
    kw = dict(mode="rate", tolerable_rate=1e-3)
    jg, tg = jplan.make_governor("kv", **kw), tplan.make_governor("kv", **kw)
    args = ([0.9, 0.88, 1.0], [1e-5, None, None])
    assert governor.fleet_report([tg, tg, None], *args) == (
        jgovernor.fleet_report([jg, jg, None], *args))


def test_governor_errors():
    _, tplan = _plans()
    with pytest.raises(ValueError, match="unknown governor mode"):
        tplan.make_governor("kv", mode="thermal")
    with pytest.raises(ValueError, match="not in plan domains"):
        tplan.make_governor("nope")
    with pytest.raises(ValueError, match="read_words_per_token"):
        tplan.make_governor("kv", read_words_per_token=0)
    with pytest.raises(CapacityError):
        tplan.make_governor("kv", required_bytes=VCU128.total_bytes)
    assert tplan.make_governor("kv", mode="adaptive").replans == 0
    gov = tplan.make_governor("kv", mode="rate")
    with pytest.raises(ValueError, match="adaptive"):
        gov.replan(None)
    with pytest.raises(CapacityError):
        gov.admit(17 * VCU128.bytes_per_pc)


# ---- generate() under the governor (reduced llama3.2-3b) ------------------

TB = get_arch("llama3.2-3b")
TCFG = dataclasses.replace(TB.reduced, dtype=torch.float32)
TOKENS = np.random.RandomState(0).randint(0, TCFG.vocab, (2, 12)).astype(
    np.int32)
MAX_LEN, NEW = 40, 8


@functools.lru_cache(maxsize=None)
def _params():
    jb = jget_arch("llama3.2-3b")
    jcfg = dataclasses.replace(jb.reduced, dtype=jnp.float32)
    jp = jinit_params(jb.module.param_specs(jcfg), jax.random.PRNGKey(0))
    return convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _serve(plan, **kw):
    return tserve.generate(TB, TCFG, _params(), {"tokens": TOKENS},
                           tserve.ServeConfig(max_len=MAX_LEN,
                                              max_new_tokens=NEW,
                                              undervolt=plan, **kw),
                           device="cpu").numpy()


@pytest.mark.parametrize("ecc", [False, True])
def test_generate_under_governor_equals_fixed_voltage(ecc):
    """generate(governor=...) serves at the governor's admitted voltage:
    its tokens equal generate(kv_voltage=admitted), the admitted voltage
    equals the reference governor's for the same plan and bytes, and the
    faults change the tokens."""
    jplan, tplan = _plans(0.95, tuple(range(32)), ecc)
    kw = dict(mode="rate", tolerable_rate=1e-3)
    gov = tplan.make_governor("kv", **kw)
    kv_bytes = tserve._kv_placement(TB, TCFG, TOKENS.shape[0],
                                    tserve.ServeConfig(
                                        max_len=MAX_LEN,
                                        undervolt=tplan))[0].total_words * 4
    admitted = gov.admit(kv_bytes)
    assert admitted == jplan.make_governor("kv", **kw).admit(kv_bytes)
    assert admitted < 0.95
    governed = _serve(tplan, governor=gov)
    np.testing.assert_array_equal(governed, _serve(tplan,
                                                   kv_voltage=admitted))
    if not ecc:
        assert (governed != _serve(None)).any()


def test_generate_governor_value_errors():
    _, tplan = _plans(0.95, tuple(range(32)))
    gov = tplan.make_governor("kv")
    with pytest.raises(ValueError, match="mutually exclusive"):
        _serve(tplan, governor=gov, kv_voltage=0.9)
    with pytest.raises(ValueError, match="built from sc.undervolt"):
        _serve(_plans(0.95, tuple(range(32)))[1], governor=gov)
    off = dataclasses.replace(tplan, enabled=False)
    with pytest.raises(ValueError, match="does not place"):
        _serve(off, governor=off.make_governor("kv"))
    other = UndervoltPlan(
        domains={"kv": MemoryDomain("kv", 0.95, tuple(range(16))),
                 "cold": MemoryDomain("cold", 0.95, tuple(range(16, 32)))},
        policy={"kv_cache": "kv"}, geometry=VCU128)
    with pytest.raises(ValueError, match="governs domain 'cold'"):
        _serve(other, governor=other.make_governor("cold"))
