"""The port's DeepSeek-V2 family (``models/moe.py``: MLA + routed experts)
and the state-arena scheduler's expert criticality tiering, on the
reduced configs in float32, held against the reference.

Weights are made with numpy from a seed (the reference's init rules) and
handed to both packages.  Float paths agree within 1e-5 (relative to the
largest magnitude); greedy tokens, routing frequencies, expert tiers and
injected expert words are equal.  Inside the port, every request the
state-arena scheduler serves equals its solo ``generate()`` replay on
``sched.params``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.domains import place_groups_tiered as jplace_tiered
from repro.core.injection import inject_group as jinject_group
from repro.models import base as jbase
from repro.models import cache as JC
from repro.models import moe as jmoe
from repro.serving import engine as jserve
from repro.training.undervolt import aggressive_plan as jaggressive_plan

from repro_torch import convert
from repro_torch.core.faultmodel import V_MIN
from repro_torch.models import base
from repro_torch.models import cache as C
from repro_torch.models import moe
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.serving.statearena import StateArenaScheduler
from repro_torch.training.undervolt import aggressive_plan

RTOL = 1e-5
MAX_LEN = 24
V_EXPERT = 0.86


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    jb, tb = jbase.get_arch(name), base.get_arch(name)
    return (jb, dataclasses.replace(jb.reduced, dtype=jnp.float32),
            tb, dataclasses.replace(tb.reduced, dtype=torch.float32))


LITE = _cfgs("deepseek-v2-lite-16b")


@functools.lru_cache(maxsize=None)
def _params(name="deepseek-v2-lite-16b"):
    """(JAX tree, torch tree) of one numpy init."""
    jb, jcfg, _, _ = _cfgs(name)
    rng = np.random.RandomState(0)

    def mk(s):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.standard_normal(s.shape) * (s.scale / np.sqrt(fan_in))
                ).astype(np.float32)

    tree = jax.tree_util.tree_map(
        mk, jb.module.param_specs(jcfg),
        is_leaf=lambda x: isinstance(x, jbase.ParamSpec))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_jax(tree))


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= RTOL, (what, err)


def _moe_layer(params):
    grp = params["stack"]["periods"]["s0_moe"]
    return {k: v[0] for k, v in grp.items()}


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mla_attn_matches_reference(mode):
    """One MLA block over a prefilled latent ring: prefill (materialized
    per-head K/V) and absorbed decode, within 1e-5."""
    _, jcfg, _, tcfg = LITE
    jp, tp = (_moe_layer(t) for t in _params())
    rng = np.random.RandomState(1)
    b, s = 2, 7
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jcache = JC.init_cache(jmoe.mla_cache_specs(jcfg, b, MAX_LEN))
    tcache = C.init_cache(moe.mla_cache_specs(tcfg, b, MAX_LEN), "cpu")
    jy, jcache = jax.jit(lambda p_, x_, c_, q_: jmoe.mla_attn(
        jcfg, p_, x_, c_, q_, "prefill"))(jp, jnp.asarray(x), jcache,
                                          jnp.asarray(pos))
    ty, tcache = moe.mla_attn(tcfg, tp, torch.from_numpy(x), tcache,
                              torch.from_numpy(pos.copy()), "prefill")
    if mode == "decode":
        x1 = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
        p1 = np.full((b, 1), s, np.int32)
        jy, jcache = jax.jit(lambda p_, x_, c_, q_: jmoe.mla_attn(
            jcfg, p_, x_, c_, q_, "decode", pos=jnp.int32(s)))(
                jp, jnp.asarray(x1), jcache, jnp.asarray(p1))
        ty, tcache = moe.mla_attn(tcfg, tp, torch.from_numpy(x1), tcache,
                                  torch.from_numpy(p1), "decode", pos=s)
    _close(ty.numpy(), jy, f"mla {mode} output")
    for k in ("ckv", "kpe"):
        _close(tcache[k].numpy(), jcache[k], f"mla {mode} cache {k}")
    np.testing.assert_array_equal(tcache["pos"].numpy(), jcache["pos"])


@pytest.mark.parametrize("cf,s", [(0.5, 6), (2.0, 1)],
                         ids=["prefill-drops", "decode"])
def test_moe_ffn_matches_reference(cf, s):
    """The routed FFN: router, stable top-k, capacity dispatch (prefill
    capacity 0.5 drops tokens; decode never drops) and the combine."""
    _, jcfg, _, tcfg = LITE
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    jp, tp = (_moe_layer(t) for t in _params())
    b = 4
    x = np.random.RandomState(2).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    jy, jaux = jax.jit(lambda p_, x_: jmoe.moe_ffn(
        jcfg, p_, x_, jmoe.ensure(None)))(jp, jnp.asarray(x))
    ty, taux = moe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    if s > 1:
        t = b * s
        cap = moe.capacity(tcfg, t, decode=False)
        probs = torch.softmax(torch.from_numpy(x).reshape(t, -1)
                              @ tp["w_router"], -1)
        load = np.bincount(moe._top_k(probs, tcfg.top_k)[1].reshape(-1),
                           minlength=tcfg.n_experts)
        assert load.max() > cap, "no expert over capacity: no drop tested"
    _close(ty.numpy(), jy, "moe_ffn y")
    _close(taux.numpy(), jaux, "moe_ffn aux")


def test_expert_rows_do_not_depend_on_capacity():
    """A token's routed output has the same bits at decode capacity 1
    (alone) and 3 (batched with two others): the expert products run on
    fixed row blocks."""
    _, _, _, tcfg = LITE
    tp = _moe_layer(_params()[1])
    x = torch.from_numpy(np.random.RandomState(3).standard_normal(
        (3, 1, tcfg.d_model)).astype(np.float32))
    batched, _ = moe.moe_ffn(tcfg, tp, x)
    for i in range(3):
        alone, _ = moe.moe_ffn(tcfg, tp, x[i:i + 1])
        assert torch.equal(alone, batched[i:i + 1]), i


def test_routing_frequency_equal():
    _, jcfg, _, tcfg = LITE
    jp, tp = _params()
    probe = np.random.RandomState(5).randint(0, jcfg.vocab, (1, 24))
    want = jmoe.routing_frequency(jp, probe, jcfg)
    got = moe.routing_frequency(tp, probe, tcfg)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "deepseek-v2-236b"])
def test_prefill_matches_reference(name):
    """Whole-model prefill logits and latent cache (236b: the q-LoRA
    query path) within 1e-5."""
    _, jcfg, tb, tcfg = _cfgs(name)
    jp, tp = _params(name)
    toks = np.random.RandomState(6).randint(0, jcfg.vocab, (2, 9))
    jl, jc = jax.jit(lambda p_, t_: jmoe.prefill(
        p_, {"tokens": t_}, jcfg, MAX_LEN))(jp, jnp.asarray(toks))
    tl, tc = moe.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                         MAX_LEN)
    _close(tl.numpy(), jl, f"{name} prefill logits")
    got = jax.tree_util.tree_leaves(_as_np(tc))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jc)[0], got):
        _close(b, a, f"{name} cache {jax.tree_util.keystr(path)}")


def _as_np(tree):
    if isinstance(tree, dict):
        return {k: _as_np(v) for k, v in tree.items()}
    return tree.numpy()


def test_greedy_tokens_equal_reference():
    """deepseek-v2-lite reduced: greedy generate() tokens equal the
    reference's (prefill, then absorbed decode over the latent ring)."""
    jb, jcfg, tb, tcfg = LITE
    jp, tp = _params()
    toks = np.random.RandomState(7).randint(0, jcfg.vocab, (2, 6))
    want = jserve.generate(jb, jcfg, jp, {"tokens": jnp.asarray(toks)},
                           jserve.ServeConfig(max_len=16, max_new_tokens=5),
                           key=jax.random.PRNGKey(0))
    got = generate(tb, tcfg, tp, {"tokens": torch.from_numpy(toks)},
                   ServeConfig(max_len=16, max_new_tokens=5), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_forward_train_names_its_slice():
    _, _, _, tcfg = LITE
    with pytest.raises(NotImplementedError, match="slice 12"):
        moe.forward_train(_params()[1], {"tokens": torch.zeros(
            (1, 4), dtype=torch.int64)}, tcfg)


# ---------------------------------------------------------------------------
# expert criticality tiering on the state-arena route
# ---------------------------------------------------------------------------


def _tiered_sched(expert_probe, num_slots=2):
    _, _, tb, tcfg = LITE
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=4,
                     undervolt=aggressive_plan(v_unsafe=V_EXPERT),
                     kv_injection="write", kv_method="bitwise")
    return ContinuousBatchingScheduler(tb, tcfg, _params()[1], sc,
                                       num_slots=num_slots, device="cpu",
                                       expert_probe=expert_probe), sc


PROBE = np.random.RandomState(5).randint(0, 257, (24,))


@functools.lru_cache(maxsize=None)
def _tiered():
    return _tiered_sched(PROBE)


def test_expert_tiers_and_injected_words_equal_reference():
    """The tiers equal the reference's ranking (hot quarter safe, cold
    quarter disposable), the placements its placement, and every expert
    placed below V_MIN carries the reference's ``inject_group`` words on
    bits; the caller's parameters are not written."""
    _, jcfg, _, tcfg = LITE
    jp, tp = _params()
    sched, _ = _tiered()
    assert isinstance(sched, StateArenaScheduler)
    freq = jmoe.routing_frequency(jp, PROBE.reshape(1, -1), jcfg)
    order = np.argsort(-freq, kind="stable")
    e, q = tcfg.n_experts, max(tcfg.n_experts // 4, 1)
    want = {int(ex): ("safe" if r < q else "disposable" if r >= e - q
                      else "cheap") for r, ex in enumerate(order)}
    assert sched.expert_tiers == want
    assert sched.stats["expert_tiers"] == {"safe": q, "disposable": q,
                                           "cheap": e - 2 * q}
    jplan = jaggressive_plan(v_unsafe=V_EXPERT)
    jfmap = jplan.fault_map()
    grp = "periods", "s0_moe"
    jg = jp["stack"][grp[0]][grp[1]]
    tg = sched.params["stack"][grp[0]][grp[1]]
    orig = _params()[1]["stack"][grp[0]][grp[1]]
    jtrees = {ex: {f"{grp[0]}/{grp[1]}/{w}": jg[w][..., ex, :, :]
                   for w in ("we_g", "we_u", "we_d")} for ex in range(e)}
    jplaced = jplace_tiered(
        {f"moe_expert[{ex:03d}]": jtrees[ex] for ex in range(e)},
        {f"moe_expert[{ex:03d}]": want[ex] for ex in range(e)},
        jplan.domains, jplan.geometry, jfmap)
    changed = 0
    for ex in range(e):
        key = f"moe_expert[{ex:03d}]"
        got_plc, want_plc = sched._expert_placements[key], jplaced[key]
        assert got_plc.domain.name == want_plc.domain.name, ex
        assert [(lp.path, lp.n_words) for lp in got_plc.leaves] == [
            (lp.path, lp.n_words) for lp in want_plc.leaves], ex
        if want_plc.domain.voltage >= V_MIN - 1e-9:
            for w in ("we_g", "we_u", "we_d"):
                assert torch.equal(tg[w][..., ex, :, :],
                                   orig[w][..., ex, :, :]), (ex, w)
            continue
        jout, _ = jinject_group(jtrees[ex], want_plc, jfmap,
                                voltage=jnp.float32(want_plc.domain.voltage),
                                method="bitwise")
        for w in ("we_g", "we_u", "we_d"):
            got = convert.tensor_to_numpy_bits(tg[w][..., ex, :, :])
            ref = np.asarray(jout[f"{grp[0]}/{grp[1]}/{w}"]).view(np.uint32)
            np.testing.assert_array_equal(got, ref, err_msg=f"{ex} {w}")
            changed += int((got != convert.tensor_to_numpy_bits(
                orig[w][..., ex, :, :])).sum())
    assert changed > 0, "no expert word faulted: the comparison is vacuous"


def test_tiered_requests_equal_their_replays():
    """Every request the tiered scheduler serves (write-path faults on the
    latent caches, corrupted experts) equals its solo generate() replay
    on ``sched.params``, and the step ran as one decode step."""
    _, jcfg, tb, tcfg = LITE
    sched, sc = _tiered_sched(PROBE)
    rng = np.random.RandomState(8)
    reqs = [(f"r{i}", rng.randint(0, jcfg.vocab, (4 + 3 * i,)), 3 + i)
            for i in range(3)]
    for rid, toks, n in reqs:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
    res = sched.run()
    assert sched.stats["decode_traces"] == 1
    for rid, toks, n in reqs:
        ref = generate(tb, tcfg, sched.params, {"tokens": toks[None]},
                       dataclasses.replace(sc, max_new_tokens=n),
                       device="cpu", kv_placement=res[rid].placement)
        np.testing.assert_array_equal(res[rid].tokens, ref.numpy(), rid)


@pytest.mark.parametrize("case", ["no-routing-frequency", "no-plan"])
def test_expert_probe_refusals(case):
    """The reference's ValueErrors: a family without routing_frequency,
    and tiering without a plan placing the caches."""
    _, _, tb, tcfg = LITE
    if case == "no-plan":
        with pytest.raises(ValueError, match="undervolt plan"):
            ContinuousBatchingScheduler(
                tb, tcfg, _params()[1], ServeConfig(max_len=MAX_LEN),
                num_slots=1, device="cpu", expert_probe=PROBE)
        return
    rb = base.get_arch("recurrentgemma-9b")
    rcfg = dataclasses.replace(rb.reduced, dtype=torch.float32)
    rparams = base.init_params(rb.module.param_specs(rcfg),
                               torch.Generator().manual_seed(0),
                               device="cpu")
    sc = ServeConfig(max_len=MAX_LEN,
                     undervolt=aggressive_plan(v_unsafe=V_EXPERT),
                     kv_injection="write", kv_method="bitwise")
    with pytest.raises(ValueError, match="MoE-only"):
        ContinuousBatchingScheduler(rb, rcfg, rparams, sc, num_slots=1,
                                    device="cpu", expert_probe=PROBE)


@pytest.mark.parametrize("feature", ["share_prefix", "extras"])
def test_state_route_features_of_later_families_name_their_slice(feature):
    """On the state route an MoE family serves, the features the whisper
    and VLM families brought hold too: under ``share_prefix`` a repeated
    prompt reuses its prefill (``prefill_reuse`` 1, ``pages_shared`` [0,
    1], equal tokens), and a request with ``extras`` is served (the
    family's prefill reads only its tokens) with the tokens of the same
    request without them.  Each request equals its solo replay."""
    _, _, tb, tcfg = LITE
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=3,
                     share_prefix=feature == "share_prefix")
    sched = ContinuousBatchingScheduler(tb, tcfg, _params()[1], sc,
                                        num_slots=1, device="cpu")
    extras = {"frames": np.zeros((4, 4), np.float32)}
    reqs = [("a", PROBE[:6], None), ("b", PROBE[:6],
                                     extras if feature == "extras" else None)]
    for rid, toks, ex in reqs:
        sched.submit(Request(rid, toks, 3, extras=ex))
    res = sched.run()
    assert sched.stats["prefill_reuse"] == (feature == "share_prefix")
    assert [res[r].pages_shared for r, *_ in reqs] == (
        [0, 1] if feature == "share_prefix" else [0, 0])
    np.testing.assert_array_equal(res["a"].tokens, res["b"].tokens)
    ref = generate(tb, tcfg, _params()[1], {"tokens": PROBE[None, :6]}, sc,
                   device="cpu", kv_placement=res["a"].placement)
    np.testing.assert_array_equal(res["a"].tokens, ref.numpy())
