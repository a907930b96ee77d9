"""The port's state-arena scheduler: the serving route of families whose
cache does not page, on the reduced recurrentgemma-9b config in float32.

Two slots serve three overlapping requests.  Every request's tokens equal
its solo ``generate(kv_placement=results[rid].placement)`` replay in the
port, greedy clean, at 0.86 V (bitwise write-path injection), at 0.868 V
with ECC and sampled; greedy clean tokens equal the reference's
``StateArenaScheduler`` on the same weights (made with numpy and handed
to both).  The front door returns the state-arena class for this family;
tiered per-slot placement equals the reference's; refused and unported
options raise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.domains import place_groups_tiered as jplace_tiered
from repro.core.hbm import VCU128 as JVCU128
from repro.models import base as jbase
from repro.serving import engine as jserve
from repro.serving import scheduler as jsched
from repro.training.undervolt import aggressive_plan as jaggressive_plan
from repro.training.undervolt import tiered_plan as jtiered_plan

from repro_torch import convert
from repro_torch.core.domains import MemoryDomain, place_groups_tiered
from repro_torch.core.hbm import VCU128
from repro_torch.kernels import _build
from repro_torch.models import base
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request, ShardLayoutError)
from repro_torch.serving.statearena import StateArenaScheduler
from repro_torch.training.undervolt import (UndervoltPlan, aggressive_plan,
                                            tiered_plan)


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


JB, TB = jbase.get_arch("recurrentgemma-9b"), base.get_arch("recurrentgemma-9b")
JCFG = dataclasses.replace(JB.reduced, dtype=jnp.float32)
TCFG = dataclasses.replace(TB.reduced, dtype=torch.float32)
MAX_LEN = 32
_RNG = np.random.RandomState(1)
# (rid, prompt, new tokens): overlapping lifetimes through two slots
REQS = [(f"r{i}", _RNG.randint(0, JCFG.vocab, (4 + 3 * i,)).astype(np.int32),
         3 + i) for i in range(3)]


@functools.lru_cache(maxsize=None)
def _params():
    """Weights made with numpy from a seed (the reference's init rules),
    handed to both packages."""
    rng = np.random.RandomState(0)

    def mk(s):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        if s.init == "const":
            return np.full(s.shape, s.scale, np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.standard_normal(s.shape) * (s.scale / np.sqrt(fan_in))
                ).astype(np.float32)

    tree = jax.tree_util.tree_map(
        mk, JB.module.param_specs(JCFG),
        is_leaf=lambda x: isinstance(x, jbase.ParamSpec))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_jax(tree))


def _plan(v, ecc):
    return UndervoltPlan(
        domains={"kv": MemoryDomain("kv", v, tuple(range(32)), ecc=ecc)},
        policy={"kv_cache": "kv"}, geometry=VCU128)


def _serve(sc, temperature=0.0, reqs=REQS):
    sched = ContinuousBatchingScheduler(TB, TCFG, _params()[1], sc,
                                        num_slots=2, num_pages=0,
                                        page_slots=0, device="cpu")
    for i, (rid, toks, n) in enumerate(reqs):
        gen = (torch.Generator().manual_seed(10 + i) if temperature > 0
               else None)
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                             generator=gen))
    return sched, sched.run()


def _replay(sc, res, temperature=0.0, reqs=REQS):
    out = {}
    for i, (rid, toks, n) in enumerate(reqs):
        gen = (torch.Generator().manual_seed(10 + i) if temperature > 0
               else None)
        out[rid] = generate(
            TB, TCFG, _params()[1], {"tokens": toks[None]},
            dataclasses.replace(sc, max_new_tokens=n), device="cpu",
            generator=gen, kv_placement=(res[rid].placement
                                         if sc.undervolt else None)).numpy()
    return out


@functools.lru_cache(maxsize=None)
def _jax_clean_tokens():
    sc = jserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=4)
    sched = jsched.ContinuousBatchingScheduler(
        JB, JCFG, _params()[0], sc, num_slots=2, num_pages=0, page_slots=0)
    for rid, toks, n in REQS:
        sched.submit(jsched.Request(rid=rid, tokens=toks, max_new_tokens=n,
                                    key=jax.random.PRNGKey(0)))
    res = sched.run()
    return {rid: res[rid].tokens for rid, *_ in REQS}


# (voltage, ecc, method, temperature)
CASES = [(None, False, "auto", 0.0), (0.86, False, "bitwise", 0.0),
         (0.868, True, "auto", 0.0), (0.86, False, "bitwise", 0.7)]


@pytest.mark.parametrize("v,ecc,method,temperature", CASES)
def test_requests_equal_solo_replay(v, ecc, method, temperature):
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=4,
                     undervolt=None if v is None else _plan(v, ecc),
                     kv_injection="write", kv_method=method,
                     temperature=temperature)
    sched, res = _serve(sc, temperature)
    assert isinstance(sched, StateArenaScheduler)
    assert sched.peak_active == 2 and sched.active == (v is not None)
    refs = _replay(sc, res, temperature)
    for rid, _, n in REQS:
        assert res[rid].tokens.shape == (1, n)
        np.testing.assert_array_equal(res[rid].tokens, refs[rid],
                                      err_msg=rid)
    if v is None and temperature == 0.0:
        want = _jax_clean_tokens()
        for rid, *_ in REQS:
            np.testing.assert_array_equal(res[rid].tokens, want[rid],
                                          err_msg=rid)
    elif temperature == 0.0:
        clean = _serve(dataclasses.replace(sc, undervolt=None))[1]
        assert any((res[r].tokens != clean[r].tokens).any()
                   for r, *_ in REQS), "no fault reached a token"
    st = sched.stats
    assert st["route"] == "state" and st["admitted"] == len(REQS)
    assert st["obs"]["totals"]["tokens_decoded"] == sum(
        n - 1 for *_, n in REQS)


def test_tiered_placement_matches_jax():
    """Per-slot placements at the state tier land where the reference's
    place_groups_tiered puts them; on a tiered plan the scheduler serves
    each slot on its placement and replays bit-exactly."""
    tspecs = base.spec_avals(TB.module.cache_specs(TCFG, 1, MAX_LEN))
    jspecs = jbase.spec_avals(JB.module.cache_specs(JCFG, 1, MAX_LEN))
    for v, tier in ((0.91, "cheap"), (0.91, "hedged"), (0.86, "critical"),
                    (0.86, "disposable")):
        tplan = tiered_plan(v_unsafe=v, geometry=VCU128)
        jplan = jtiered_plan(v_unsafe=v, geometry=JVCU128)
        groups = [f"kv_cache[{i:04d}]" for i in range(3)]
        got = place_groups_tiered({g: tspecs for g in groups},
                                  {g: tier for g in groups}, tplan.domains,
                                  tplan.geometry, tplan.fault_map())
        want = jplace_tiered({g: jspecs for g in groups},
                             {g: tier for g in groups}, jplan.domains,
                             jplan.geometry, jplan.fault_map())
        for g in groups:
            assert got[g].domain.name == want[g].domain.name, (v, tier)
            assert [(lp.path, lp.n_words, [dataclasses.astuple(s)
                                           for s in lp.segments])
                    for lp in got[g].leaves] == [
                (lp.path, lp.n_words, [dataclasses.astuple(s)
                                       for s in lp.segments])
                for lp in want[g].leaves], (v, tier, g)
    plan = aggressive_plan(0.88, geometry=VCU128)
    jplan = jaggressive_plan(0.88, geometry=JVCU128)
    assert plan.policy == jplan.policy
    assert [dataclasses.astuple(d) for d in plan.domains.values()] == [
        dataclasses.astuple(d) for d in jplan.domains.values()]
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=4,
                     undervolt=tiered_plan(v_unsafe=0.91, geometry=VCU128),
                     kv_injection="write")
    sched, res = _serve(sc, reqs=REQS[:2])
    assert sched.state_tier == "cheap"
    assert [p.domain.name for p in sched.placements] == ["cheap", "cheap"]
    refs = _replay(sc, res, reqs=REQS[:2])
    for rid, *_ in REQS[:2]:
        np.testing.assert_array_equal(res[rid].tokens, refs[rid])


def test_refused_and_unported_options_raise():
    tp = _params()[1]
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=2,
                     undervolt=_plan(0.86, False))
    kw = dict(num_slots=2, device="cpu")
    for extra, err, match in (
            (dict(mesh=object()), ShardLayoutError, "single-shard"),
            (dict(shard_seeds=(1, 2)), ShardLayoutError, "single-shard"),
            (dict(self_heal=object()), ValueError, "self_heal"),
            (dict(expert_probe=np.arange(8)), ValueError, "MoE-only")):
        with pytest.raises(err, match=match):
            ContinuousBatchingScheduler(TB, TCFG, tp, sc, **kw, **extra)
    for change, err, match in (
            (dict(governor=object()), ValueError, "governor"),
            (dict(kv_injection="read"), ValueError, "read-path"),
            (dict(kv_injection="rewrite"), ValueError, "rewrite"),
            (dict(kv_injection="bogus"), ValueError, "unknown"),
            (dict(share_prefix=True), NotImplementedError, "slice 12")):
        with pytest.raises(err, match=match):
            ContinuousBatchingScheduler(
                TB, TCFG, tp, dataclasses.replace(sc, **change), **kw)
    sched = ContinuousBatchingScheduler(TB, TCFG, tp, sc, **kw)
    with pytest.raises(NotImplementedError, match="slice 12"):
        sched.submit(Request("x", REQS[0][1], 2,
                             extras={"frames": np.zeros((4, 4))}))
    with pytest.raises(ValueError, match="exceed max_len"):
        sched.submit(Request("y", np.zeros((31,), np.int32), 2))
    with pytest.raises(ValueError, match="empty prompt"):
        sched.submit(Request("z", np.zeros((0,), np.int32), 2))
    assert not sched.queue


@pytest.mark.cuda
def test_state_arena_on_card(cuda_device):
    """On the card (K7 at admission, K8 every step): requests equal their
    solo replays and K8 runs once per recurrent layer and step."""
    params = base.init_params(TB.module.param_specs(TCFG),
                              torch.Generator(device=cuda_device).manual_seed(0),
                              device=cuda_device)
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=4,
                     undervolt=_plan(0.86, False), kv_injection="write",
                     kv_method="bitwise")
    sched = ContinuousBatchingScheduler(TB, TCFG, params, sc, num_slots=2,
                                        device=cuda_device)
    for rid, toks, n in REQS:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
    _build.reset_launch_counts()
    res = sched.run()
    n_rec = TCFG.layer_kinds().count("rec")
    counts = _build.launch_counts()
    assert counts["rglru_scan"] == n_rec * (sched.steps + len(REQS))
    assert counts["flash_prefill"] == TCFG.layer_kinds().count("local") * len(
        REQS)
    for rid, toks, n in REQS:
        ref = generate(TB, TCFG, params, {"tokens": toks[None]},
                       dataclasses.replace(sc, max_new_tokens=n),
                       device=cuda_device, kv_placement=res[rid].placement)
        np.testing.assert_array_equal(res[rid].tokens, ref.cpu().numpy())
