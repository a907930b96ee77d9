"""The port's mesh-sharded paged scheduler (logical shards on one device)
held against the reference's sharded scheduler and against itself.

Host logic equals the reference on bits and words: the per-shard fault-map
seeds, the layout validation (results and error messages), each shard's
fault map (threshold tables and weak rows) and the mesh-argument errors.
Inside the port, on the reduced llama3.2-3b: a mesh of one equals the
unsharded scheduler (tokens and per-step counters); with 2 and 4 shards
every request equals its solo ``generate()`` replay on its shard's plan,
in read and write modes and with ECC; admission follows the shard order;
a CapacityError names its shard; heterogeneous setpoints give
heterogeneous voltages; self-healing escalates a setpoint instead of
refusing an admission.  The whole slice is held against the reference's
2-shard scheduler, run in a subprocess with two forced host devices.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.domains import MemoryDomain as JDomain
from repro.core.hbm import VCU128 as JVCU128
from repro.core.hbm import fleet_map_seeds as jfleet_map_seeds
from repro.models.base import get_arch as jget_arch
from repro.models.base import init_params as jinit_params
from repro.serving import engine as jserve
from repro.serving import scheduler as jsched
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core.domains import CapacityError, MemoryDomain
from repro_torch.core.hbm import VCU128, fleet_map_seeds
from repro_torch.launch.mesh import SERVE_AXIS, make_serve_mesh
from repro_torch.models.base import get_arch, init_params
from repro_torch.obs.metrics import N_STEP_COUNTERS
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request, SelfHealConfig,
                                           ShardLayoutError,
                                           validate_shard_layout)
from repro_torch.training.undervolt import UndervoltPlan

TB = get_arch("llama3.2-3b")
CFG = TB.reduced                          # bf16, 2 layers
PS = 8
ALL_PCS = tuple(range(32))
WORST_PCS = (8, 15, 18, 29)
_R = np.random.RandomState(7)
# (rid, prompt, max_new_tokens, tier, generator seed)
REQS = [(i, _R.randint(0, CFG.vocab, (6 + i,)), 4, "cheap", 100 + i)
        for i in range(6)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _params():
    return init_params(TB.module.param_specs(CFG),
                       torch.Generator().manual_seed(0), device="cpu")


def _plan(v=0.88, ecc=False, pcs=ALL_PCS):
    return UndervoltPlan(
        domains={"kv": MemoryDomain("kv", v, pcs, ecc=ecc)},
        policy={"kv_cache": "kv"}, geometry=VCU128)


def _jplan(v=0.88, ecc=False, pcs=ALL_PCS):
    return JPlan(domains={"kv": JDomain("kv", v, pcs, ecc=ecc)},
                 policy={"kv_cache": "kv"}, geometry=JVCU128)


def _sc(mode="read", temperature=0.0, plan=None, method="bitwise", **kw):
    kw.setdefault("max_new_tokens", 4)
    return ServeConfig(max_len=32, temperature=temperature,
                       undervolt=plan, kv_injection=mode, kv_method=method,
                       **kw)


def _mesh(n):
    return make_serve_mesh(n, devices=["cpu"] * n)


def _sched(sc, n_shards, mesh=True, **kw):
    kw.setdefault("num_slots", 2 * n_shards)
    kw.setdefault("num_pages", 8 * n_shards)
    kw.setdefault("page_slots", PS)
    if mesh:
        kw["mesh"] = _mesh(n_shards)
    return ContinuousBatchingScheduler(TB, CFG, _params(), sc, device="cpu",
                                       **kw)


def _submit(sched, reqs):
    for rid, toks, n, tier, seed in reqs:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                             tier=tier,
                             generator=torch.Generator().manual_seed(seed)))


def _serve(sc, n_shards, reqs=REQS, **kw):
    sched = _sched(sc, n_shards, **kw)
    _submit(sched, reqs)
    return sched, sched.run()


def _assert_replays(sched, sc, res, reqs=REQS):
    """Each request alone through generate() on its shard's plan and its
    own pages."""
    for rid, toks, n, tier, seed in reqs:
        sc_k = dataclasses.replace(
            sc, undervolt=sched.shard_plan(res[rid].shard), max_new_tokens=n)
        ref = generate(TB, CFG, _params(), {"tokens": toks[None]}, sc_k,
                       device="cpu",
                       generator=torch.Generator().manual_seed(seed),
                       kv_placement=res[rid].placement)
        np.testing.assert_array_equal(ref.numpy(), res[rid].tokens,
                                      err_msg=str(rid))


# ---------------------------------------------------------------------------
# host logic == the reference
# ---------------------------------------------------------------------------


def test_fleet_map_seeds_equal_reference():
    for base in (0, 469, 2**32 - 1):
        for n in (1, 2, 3, 8):
            assert fleet_map_seeds(base, n) == jfleet_map_seeds(base, n)
    assert fleet_map_seeds(469, 8)[0] == 469
    with pytest.raises(ValueError, match="must be >= 1"):
        fleet_map_seeds(0, 0)


@pytest.mark.parametrize("args,kw", [
    ((4, 8, 16), {}),
    ((2, 4, 16), dict(base_seed=7, setpoints=[1e-9, None])),
    ((4, 6, 16), {}),                                # indivisible slots
    ((4, 8, 18), {}),                                # indivisible pages
    ((2, 4, 16), dict(seeds=[7, 7])),                # seed collision
    ((2, 4, 16), dict(seeds=[1, 2, 3])),             # seed count
    ((2, 4, 16), dict(setpoints=[1.0])),             # setpoint count
    ((0, 4, 16), {}),                                # no shard
], ids=["ok", "ok-setpoints", "slots", "pages", "collision", "seed-count",
        "setpoint-count", "zero"])
def test_validate_shard_layout_equals_reference(args, kw):
    """Equal resolved seeds and setpoints, or an equal refusal message."""
    def run(fn, err):
        try:
            return fn(*args, **kw)
        except err as e:
            return ("refused", str(e))
    got = run(validate_shard_layout, ShardLayoutError)
    want = run(jsched.validate_shard_layout, jsched.ShardLayoutError)
    assert got == want


def test_shard_fault_maps_equal_reference():
    """Each shard's fault map (seeds from fleet_map_seeds of the plan's):
    threshold tables at two voltages and every PC's weak rows equal the
    reference's on bits, and shard maps differ from one another."""
    seeds = fleet_map_seeds(_plan().map_seed, 4)
    maps = []
    for seed in seeds:
        fm = dataclasses.replace(_plan(), map_seed=seed).fault_map()
        jfm = dataclasses.replace(_jplan(), map_seed=seed).fault_map()
        assert fm.seed == jfm.seed == seed
        for v in (0.88, 0.91):
            np.testing.assert_array_equal(
                np.asarray(fm.threshold_table(v)).view(np.uint32),
                np.asarray(jfm.threshold_table(v)).view(np.uint32))
        for pc in range(VCU128.num_pcs):
            np.testing.assert_array_equal(fm.weak_row_mask(pc),
                                          jfm.weak_row_mask(pc))
        maps.append(fm)
    for a in range(4):
        for b in range(a + 1, 4):
            assert not all(np.array_equal(maps[a].weak_row_mask(pc),
                                          maps[b].weak_row_mask(pc))
                           for pc in range(VCU128.num_pcs))


@pytest.mark.parametrize("case", ["seeds-without-mesh", "axis-missing",
                                  "setpoints-without-governor"])
def test_mesh_argument_errors_equal_reference(case):
    """The reference's ShardLayoutError, message for message."""
    def port():
        kw = dict(num_slots=2, num_pages=8, page_slots=PS, device="cpu")
        if case == "seeds-without-mesh":
            kw["shard_seeds"] = [1, 2]
        elif case == "axis-missing":
            kw["mesh"] = make_serve_mesh(1, axis="data", devices=["cpu"])
        else:
            kw.update(mesh=_mesh(1), shard_setpoints=[0.9])
        ContinuousBatchingScheduler(TB, CFG, None, _sc(plan=_plan()), **kw)

    def ref():
        kw = dict(num_slots=2, num_pages=8, page_slots=PS)
        if case == "seeds-without-mesh":
            kw["shard_seeds"] = [1, 2]
        elif case == "axis-missing":
            kw["mesh"] = jax.sharding.Mesh(np.asarray(jax.devices()[:1]),
                                           ("data",))
        else:
            from repro.launch.mesh import make_serve_mesh as jmesh
            kw.update(mesh=jmesh(1), shard_setpoints=[0.9])
        jsched.ContinuousBatchingScheduler(
            jget_arch("llama3.2-3b"), jget_arch("llama3.2-3b").reduced, None,
            jserve.ServeConfig(max_len=32, undervolt=_jplan(),
                               kv_injection="read", kv_method="bitwise"),
            **kw)
    with pytest.raises(jsched.ShardLayoutError) as want:
        ref()
    with pytest.raises(ShardLayoutError) as got:
        port()
    assert str(got.value) == str(want.value)


def test_serve_mesh_and_its_device_check():
    """make_serve_mesh names one device per shard (logical shards share
    one); the scheduler refuses shards on another device than its own
    when no process group spans them (over ranks, see
    test_torch_ranks.py), and the state-arena route still refuses any
    mesh."""
    mesh = _mesh(3)
    assert mesh.axis_names == (SERVE_AXIS,) and mesh.shape == {"serve": 3}
    assert mesh.devices == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="one device per shard"):
        make_serve_mesh(2, devices=["cpu"])
    with pytest.raises(ShardLayoutError, match="no process group spans"):
        ContinuousBatchingScheduler(
            TB, CFG, None, _sc(plan=_plan()), num_slots=2, num_pages=8,
            page_slots=PS, device="cpu",
            mesh=make_serve_mesh(2, devices=["cpu", "meta"]))
    moe = get_arch("deepseek-v2-lite-16b")
    with pytest.raises(ShardLayoutError, match="single-shard"):
        ContinuousBatchingScheduler(
            moe, moe.reduced, None, _sc("write", plan=_plan()), num_slots=2,
            num_pages=8, page_slots=PS, device="cpu", mesh=_mesh(2))


# ---------------------------------------------------------------------------
# the port: sharded serving
# ---------------------------------------------------------------------------


def test_mesh1_equals_unsharded_on_bits():
    """A mesh of one shard serves the tokens, pages and per-step counters
    of the unsharded scheduler."""
    sc = _sc(plan=_plan())
    reqs = REQS[:3]
    runs = []
    for mesh in (False, True):
        sched = _sched(sc, 1, mesh=mesh)
        _submit(sched, reqs)
        counters = []
        while sched.queue or sched.n_active:
            sched.admit_pending()
            sched.step_once()
            counters.append(sched.state["mtr"].numpy().copy())
        runs.append((sched, counters))
    (a, ca), (b, cb) = runs
    for rid, *_ in reqs:
        np.testing.assert_array_equal(a.results[rid].tokens,
                                      b.results[rid].tokens)
        np.testing.assert_array_equal(a.results[rid].page_ids,
                                      b.results[rid].page_ids)
        assert a.results[rid].shard == b.results[rid].shard == 0
    assert len(ca) == len(cb)
    for x, y in zip(ca, cb):
        np.testing.assert_array_equal(x, y)
    assert b.stats["n_shards"] == 1 and b.stats["decode_traces"] == 1
    assert b.stats["shards"][0]["map_seed"] == _plan().map_seed


@pytest.mark.parametrize("n,mode,temperature,ecc", [
    (2, "read", 0.0, False), (2, "write", 0.7, False),
    (4, "read", 0.0, True), (4, "write", 0.0, False)])
def test_sharded_requests_match_solo_replay(n, mode, temperature, ecc):
    """Every request == its solo replay on its shard's plan; every shard
    serves; one decode trace; K4 once per shard and layer per step."""
    sc = _sc(mode, temperature, _plan(ecc=ecc),
             method="word" if ecc else "bitwise")
    sched, res = _serve(sc, n)
    assert sched.stats["decode_traces"] == 1
    assert {res[rid].shard for rid, *_ in REQS} == set(range(n))
    seeds = [s["map_seed"] for s in sched.stats["shards"]]
    assert seeds == list(fleet_map_seeds(_plan().map_seed, n))
    for rid, *_ in REQS:
        assert res[rid].placement.map_seed == seeds[res[rid].shard]
    _assert_replays(sched, sc, res)


def test_k4_runs_once_per_shard_and_layer(monkeypatch):
    """The decode-only step launches the paged kernel once per shard and
    layer, each with its shard's page tables and fault-map seed."""
    from repro_torch.kernels.flash_attention import faulty
    calls = []
    real = faulty.paged_decode_attention

    def counted(*a, **kw):
        calls.append((kw["seed"], a[4].shape[0]))
        return real(*a, **kw)
    monkeypatch.setattr(faulty, "paged_decode_attention", counted)
    sched = _sched(_sc(plan=_plan()), 2)
    _submit(sched, REQS[:4])
    sched.admit_pending()
    while any(not d for d, r in zip(sched._dec_h, sched._slots)
              if r is not None):
        sched.step_once()
    calls.clear()
    sched.step_once()
    seeds = fleet_map_seeds(_plan().map_seed, 2)
    assert calls == [(seeds[0], 2)] * CFG.n_layers + [(seeds[1], 2)] \
        * CFG.n_layers


def test_admission_routes_by_shard_order():
    """Each admission lands on the first shard of ``_shard_order`` (most
    free pages, ties to the lowest index)."""
    sched = _sched(_sc(plan=_plan()), 2, num_slots=4, num_pages=16)
    landed = []
    for i, req in enumerate(REQS[:4]):
        want = sched._shard_order()[0]
        _submit(sched, [req])
        assert sched.admit_pending() == 1
        landed.append(sched._meta[req[0]].shard)
        assert landed[-1] == want, i
        sched.step_once()
    assert landed == [0, 1, 0, 1]
    sched.run()


def test_capacity_error_names_the_exhausted_shard():
    sched = _sched(_sc(plan=_plan()), 2, num_slots=4, num_pages=2)
    sched.submit(Request(rid="big", tokens=np.arange(1, 9)))
    with pytest.raises(CapacityError, match="on shard") as ei:
        sched.run()
    assert ei.value.shard in (0, 1)
    assert ei.value.free_bytes >= 0


def test_replay_against_the_wrong_shard_map_is_refused():
    sc = _sc(plan=_plan())
    sched, res = _serve(sc, 2, REQS[:4])
    rid, toks = next((r, t) for r, t, *_ in REQS[:4] if res[r].shard == 1)
    with pytest.raises(ValueError, match="served on"):
        generate(TB, CFG, _params(), {"tokens": toks[None]}, sc,
                 device="cpu", kv_placement=res[rid].placement)


def _governed(setpoints=(1e-9, 1e-4), reqs=REQS[:4]):
    plan = _plan(0.91)
    gov = plan.make_governor("kv", mode="rate", tolerable_rate=1e-3,
                             v_lo=0.87)
    sc = _sc(plan=plan, governor=gov)
    return _serve(sc, 2, reqs, shard_setpoints=setpoints)


def test_heterogeneous_setpoints_give_heterogeneous_voltages():
    """Two governed shards: the stricter rate setpoint runs the higher
    voltage; the fleet report covers both; per-shard stats, counters
    and energy."""
    sched, res = _governed()
    st = sched.stats
    vs = [s["voltage"] for s in st["shards"]]
    assert vs[0] > vs[1]
    assert sched.pricing_voltages == vs
    assert [s["setpoint"] for s in st["shards"]] == [1e-9, 1e-4]
    fleet = st["fleet"]
    assert len(fleet["shards"]) == 2
    assert fleet["power_factor_max"] >= fleet["power_factor_mean"]
    assert fleet["worst_rate"] <= 1e-4 * (1 + 1e-9)
    assert {res[rid].shard for rid in res} == {0, 1}
    assert st["n_shards"] == 2 and st["free_pages"] == 16
    for s in st["shards"]:
        assert s["active"] == 0 and s["free_pages"] == 8
        assert s["weak_pages"] >= 0
    c = sched.metrics.counters_np(sched.state)
    assert c.shape == (2, N_STEP_COUNTERS)
    assert c[:, 0].sum() == sum(r.tokens.shape[1] - 1 for r in res.values())
    en = sched.metrics.energy(sched.state, sched.pricing_voltages)
    assert [e["voltage"] for e in en["shards"]] == vs
    if c[0, 0] and c[1, 0]:
        assert en["shards"][0]["pj_per_byte"] >= en["shards"][1][
            "pj_per_byte"]


def test_weaken_row_reaches_only_its_shard():
    """The chaos hook on shard 1 marks shard 1's pages only."""
    sc = _sc(plan=_plan(0.91, ecc=True, pcs=WORST_PCS), method="word")
    sched = _sched(sc, 2, self_heal=SelfHealConfig())
    sh = sched._shards[1]
    pc, row = sh.pool.page_rows(0)[0]
    pids = sched.weaken_row(1, pc, row)
    assert len(pids) and sh.chaos[pids].all()
    assert not sched._shards[0].chaos.any()
    with pytest.raises(ValueError, match="out of range"):
        sched.weaken_row(2, pc, row)


def test_setpoint_escalation_degrades_gracefully():
    """After the posterior-driven replan pushes every grid voltage above
    a frontier-edge rate setpoint, the next admission escalates the
    shard's setpoint one decade (quarantine pressure is real) instead of
    failing (the reference's test, on shard 1 of two)."""
    plan = UndervoltPlan(
        domains={"kv": MemoryDomain("kv", 0.91, WORST_PCS[:1], ecc=True)},
        policy={"kv_cache": "kv"}, geometry=VCU128)
    gov = plan.make_governor("kv", mode="adaptive", tolerable_rate=1.0,
                             v_hi=0.91, v_lo=0.89)
    sc = _sc(plan=plan, method="word", governor=gov, max_new_tokens=16)
    sched = _sched(sc, 2, num_slots=4, num_pages=32,
                   self_heal=SelfHealConfig())
    sh = sched._shards[1]
    s0 = sh.governor.rate_at(0.91) * 1.00002     # feasible only pre-replan
    sched._shards[0].setpoint = 1.0
    sh.setpoint = s0
    r = np.random.RandomState(3)
    # the first lands on shard 0 (a tie), the second on shard 1
    for rid, n in (("r0", 16), ("r1", 16)):
        sched.submit(Request(rid=rid, tokens=r.randint(0, CFG.vocab, (6,)),
                             max_new_tokens=n))
    assert sched.admit_pending() == 2
    assert sched._meta["r1"].shard == 1
    for _ in range(2):
        sched.step_once()
    pc, row = sh.pool.page_rows(sorted(sh.pool._owned)[0])[0]
    sched.weaken_row(1, pc, row)
    for _ in range(10):
        sched.step_once()
        st = sched.stats["shards"][1]
        if st["governor_replans"] >= 1 and st["quarantined_pages"] >= 1:
            break
    assert st["governor_replans"] >= 1, st
    assert st["quarantined_pages"] >= 1, st
    # r2 takes shard 0's last slot (a tie on free pages goes to shard 0),
    # so r3 can only land on shard 1, whose frontier moved past s0
    for rid in ("r2", "r3"):
        sched.submit(Request(rid=rid, tokens=r.randint(0, CFG.vocab, (7,)),
                             max_new_tokens=4))
    assert sched.admit_pending() == 2
    assert [sched._meta[rid].shard for rid in ("r2", "r3")] == [0, 1]
    assert sched.stats["shards"][1]["setpoint_escalations"] >= 1
    assert sh.setpoint > s0
    assert sched.trace.counts.get("escalation", 0) >= 1
    res = sched.run()
    assert len(res) == 4
    assert sched.stats["decode_traces"] == 1


# ---------------------------------------------------------------------------
# the whole slice against the reference's sharded scheduler
# ---------------------------------------------------------------------------

_REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.domains import MemoryDomain
from repro.core.hbm import VCU128
from repro.launch.mesh import make_serve_mesh
from repro.models.base import get_arch, init_params
from repro.serving.engine import ServeConfig
from repro.serving.scheduler import ContinuousBatchingScheduler, Request
from repro.training.undervolt import UndervoltPlan

spec = json.loads(sys.argv[1])
jb = get_arch("llama3.2-3b")
cfg = dataclasses.replace(jb.reduced, dtype=jnp.float32)
params = init_params(jb.module.param_specs(cfg), jax.random.PRNGKey(0))
plan = UndervoltPlan(
    domains={"kv": MemoryDomain("kv", spec["v"], tuple(range(32)))},
    policy={"kv_cache": "kv"}, geometry=VCU128)
gov = plan.make_governor("kv", mode="rate", tolerable_rate=1e-3,
                         v_lo=spec["v_lo"])
sc = ServeConfig(max_len=32, max_new_tokens=4, undervolt=plan, governor=gov,
                 kv_injection="read", kv_method="word")
s = ContinuousBatchingScheduler(
    jb, cfg, params, sc, num_slots=4, num_pages=16, page_slots=8,
    mesh=make_serve_mesh(2), shard_setpoints=spec["setpoints"])
for rid, toks, n in spec["reqs"]:
    s.submit(Request(rid=rid, tokens=np.asarray(toks, np.int32),
                     max_new_tokens=n))
res = s.run()
st = s.stats
print(json.dumps({
    "results": {str(r): dict(tokens=np.asarray(v.tokens).tolist(),
                             shard=int(v.shard),
                             page_ids=np.asarray(v.page_ids).tolist(),
                             voltage=float(v.voltage))
                for r, v in res.items()},
    "shards": [{k: (float(v) if isinstance(v, (float, np.floating)) else v)
                for k, v in row.items()} for row in st["shards"]],
    "pricing": [float(v) for v in s.pricing_voltages],
    "traces": len(s.traces)}))
"""


def test_two_shard_slice_equals_reference_scheduler():
    """The reference's 2-shard scheduler (two forced host devices, in a
    subprocess) and the port's, on float32 weights of one reference init,
    governed with setpoints (1e-9, 1e-4): equal greedy tokens, shard of
    every request, page ids, admission voltages, per-shard page counts,
    voltages and map seeds, and pricing voltages."""
    spec = dict(v=0.91, v_lo=0.87, setpoints=[1e-9, 1e-4],
                reqs=[(str(rid), toks.tolist(), n)
                      for rid, toks, n, *_ in REQS[:4]])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, json.dumps(spec)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        sched, res = _serve_like_reference(spec)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    ref = json.loads(out.strip().splitlines()[-1])
    assert ref["traces"] == 1 == sched.stats["decode_traces"]
    assert set(ref["results"]) == set(res)
    for rid, want in ref["results"].items():
        got = res[rid]
        assert got.tokens.tolist() == want["tokens"], rid
        assert got.shard == want["shard"], rid
        assert got.page_ids.tolist() == want["page_ids"], rid
        assert np.float32(got.voltage) == np.float32(want["voltage"]), rid
    assert {r.shard for r in res.values()} == {0, 1}
    for got, want in zip(sched.stats["shards"], ref["shards"]):
        for key in ("shard", "active", "free_pages", "weak_pages",
                    "shared_pages", "setpoint", "map_seed"):
            assert got[key] == want[key], key
        assert np.float32(got["voltage"]) == np.float32(want["voltage"])
    assert [np.float32(v) for v in sched.pricing_voltages] == [
        np.float32(v) for v in ref["pricing"]]
    assert ref["shards"][0]["voltage"] > ref["shards"][1]["voltage"]


def _serve_like_reference(spec):
    """The port's side of the subprocess comparison: float32 weights of
    the reference's init, the same plan, governor and requests."""
    jb = jget_arch("llama3.2-3b")
    jcfg = dataclasses.replace(jb.reduced, dtype=jnp.float32)
    jp = jinit_params(jb.module.param_specs(jcfg), jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(CFG, dtype=torch.float32)
    plan = _plan(spec["v"])
    gov = plan.make_governor("kv", mode="rate", tolerable_rate=1e-3,
                             v_lo=spec["v_lo"])
    sched = ContinuousBatchingScheduler(
        TB, tcfg, convert.params_from_jax(jax.tree.map(np.asarray, jp)),
        _sc(plan=plan, method="word", governor=gov), num_slots=4,
        num_pages=16, page_slots=PS, device="cpu", mesh=_mesh(2),
        shard_setpoints=spec["setpoints"])
    for rid, toks, n in spec["reqs"]:
        sched.submit(Request(rid=rid, tokens=np.asarray(toks),
                             max_new_tokens=n))
    return sched, sched.run()
