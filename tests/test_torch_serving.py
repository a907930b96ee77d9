"""The port's undervolted serving path held against the JAX reference.

``generate`` on the reduced llama3.2-3b config, with weights converted
from the reference's init: greedy tokens equal the reference's in
float32 for the read and write injection modes, ECC off and on, at a
faulty voltage and at the guardband.  Inside the port, read == write
== rewrite token for token, greedy and sampled.  The post-prefill cache
after write-path injection is bit-equal to the reference's when both
start from the same cache.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.domains import MemoryDomain as JDomain
from repro.core.hbm import VCU128 as JVCU128
from repro.models.base import get_arch as jget_arch
from repro.models.base import init_params as jinit_params
from repro.serving import engine as jserve
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.faultmap_posterior import FaultMapPosterior
from repro_torch.core.hbm import VCU128
from repro_torch.core.injection import inject_group
from repro_torch.models.base import get_arch, init_params
from repro_torch.serving import engine as tserve
from repro_torch.training.undervolt import UndervoltPlan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

JB, TB = jget_arch("llama3.2-3b"), get_arch("llama3.2-3b")
JCFG = dataclasses.replace(JB.reduced, dtype=jnp.float32)
TCFG = dataclasses.replace(TB.reduced, dtype=torch.float32)
TOKENS = np.random.RandomState(0).randint(0, JCFG.vocab, (2, 12)).astype(
    np.int32)
MAX_LEN, NEW = 40, 8
# (voltage, ecc): a faulty point where injection changes the tokens, the
# same point under ECC (every codeword it hits there is corrected), and the
# guardband bottom.  Deeper ECC points are held on bits by the post-prefill
# test instead: whether a codeword is corrected depends on the data bits,
# and a freshly computed float32 K/V row may differ from the reference's
# in its last bit (sums in another order), flipping a codeword between
# corrected and uncorrectable.
CASES = [(0.88, False), (0.88, True), (0.98, False), (0.98, True)]


def _plans(v, ecc):
    pcs = tuple(range(32))
    return (JPlan(domains={"kv": JDomain("kv", v, pcs, ecc=ecc)},
                  policy={"kv_cache": "kv"}, geometry=JVCU128),
            UndervoltPlan(domains={"kv": MemoryDomain("kv", v, pcs, ecc=ecc)},
                          policy={"kv_cache": "kv"}, geometry=VCU128))


@functools.lru_cache(maxsize=None)
def _params():
    jp = jinit_params(JB.module.param_specs(JCFG), jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


@functools.lru_cache(maxsize=None)
def _jax_tokens(v, ecc):
    """The reference's greedy tokens (read mode; its own tests hold
    read == write)."""
    jp, _ = _params()
    plan = None if v is None else _plans(v, ecc)[0]
    return np.asarray(jserve.generate(
        JB, JCFG, jp, {"tokens": jnp.asarray(TOKENS)},
        jserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                           undervolt=plan)))


@functools.lru_cache(maxsize=None)
def _jax_prefill():
    jp, _ = _params()
    return jax.jit(lambda p, t: JB.module.prefill(
        p, {"tokens": t}, JCFG, MAX_LEN))(jp, jnp.asarray(TOKENS))


def _port_tokens(v, ecc, mode, cfg=TCFG, params=None, temperature=0.0,
                 seed=None):
    params = _params()[1] if params is None else params
    plan = None if v is None else _plans(v, ecc)[1]
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return tserve.generate(
        TB, cfg, params, {"tokens": TOKENS},
        tserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                           undervolt=plan, kv_injection=mode,
                           temperature=temperature),
        device="cpu", generator=gen).numpy()


def test_clean_generate_matches_jax():
    np.testing.assert_array_equal(_port_tokens(None, False, "auto"),
                                  _jax_tokens(None, False))


@pytest.mark.parametrize("mode", ["read", "write"])
@pytest.mark.parametrize("v,ecc", CASES)
def test_greedy_tokens_match_jax_f32(v, ecc, mode):
    clean = _jax_tokens(None, False)
    # the reference is a no-op in the guardband (its own tests hold that)
    ref = clean if v >= 0.98 else _jax_tokens(v, ecc)
    np.testing.assert_array_equal(_port_tokens(v, ecc, mode), ref)
    if not ecc and v < 0.98:
        assert (ref != clean).any()      # the undervolted cache really faults


@pytest.mark.parametrize("mode", ["read", "write"])
def test_timings_keep_injection_out_of_the_decode_span(mode):
    """``timings=`` splits prefill, the once-per-request injection and the
    decode loop (and times each decode step), and leaves the tokens as
    they are."""
    plan = _plans(0.88, False)[1]
    sc = tserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                            undervolt=plan, kv_injection=mode)
    timings = {}
    toks = tserve.generate(TB, TCFG, _params()[1], {"tokens": TOKENS}, sc,
                           device="cpu", timings=timings).numpy()
    assert timings["mode"] == mode
    assert set(timings) == {"mode", "prefill", "inject", "decode", "steps"}
    assert all(timings[k] > 0.0 for k in ("prefill", "inject", "decode"))
    assert len(timings["steps"]) == NEW - 1
    assert 0.0 < sum(timings["steps"]) <= timings["decode"]
    np.testing.assert_array_equal(toks, _port_tokens(0.88, False, mode))


def test_prefill_logits_match_jax_f32():
    jp, tp = _params()
    jl, jc = _jax_prefill()
    tl, tc = TB.module.prefill(tp, {"tokens": torch.from_numpy(TOKENS)}, TCFG,
                               MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    leaf = jc["periods"]["s0_global"]
    np.testing.assert_array_equal(tc["periods"]["s0_global"]["pos"].numpy(),
                                  np.asarray(leaf["pos"]))
    np.testing.assert_allclose(tc["periods"]["s0_global"]["k"].numpy(),
                               np.asarray(leaf["k"]), rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _bf16_params():
    cfg = dataclasses.replace(TB.reduced, dtype=torch.bfloat16)
    return cfg, init_params(TB.module.param_specs(cfg),
                            torch.Generator().manual_seed(1), device="cpu")


@pytest.mark.parametrize("v,ecc,method,temperature,seed", [
    (0.88, False, "auto", 0.0, None), (0.86, False, "bitwise", 0.8, 5),
    (0.87, True, "auto", 0.8, 5)])
def test_read_equals_write_equals_rewrite_in_port(v, ecc, method,
                                                  temperature, seed):
    cfg, params = _bf16_params()
    outs = {}
    for mode in ("read", "write", "rewrite"):
        plan = _plans(v, ecc)[1]
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        outs[mode] = tserve.generate(
            TB, cfg, params, {"tokens": TOKENS},
            tserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                               undervolt=plan, kv_injection=mode,
                               kv_method=method, temperature=temperature),
            device="cpu", generator=gen)
    assert torch.equal(outs["read"], outs["write"])
    assert torch.equal(outs["read"], outs["rewrite"])
    if method == "bitwise":          # deep in the collapse regime
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        clean = tserve.generate(
            TB, cfg, params, {"tokens": TOKENS},
            tserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                               temperature=temperature), device="cpu",
            generator=gen)
        assert not torch.equal(outs["read"], clean)


@pytest.mark.parametrize("v,ecc", [(0.88, False), (0.87, True)])
def test_post_prefill_injection_bit_equal_to_jax(v, ecc):
    """Write-path init injection of the same prefill cache (converted
    from the reference's) gives the same bits in both packages."""
    jp, _ = _params()
    jplan, tplan = _plans(v, ecc)
    _, jcache = _jax_prefill()
    tcache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache))
    sc = jserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                            undervolt=jplan, kv_injection="write")
    jeng = jserve.build_decode_engine(JB, JCFG, sc, 2, TOKENS.shape[1],
                                      static_voltage=v)
    ref = jax.tree.map(np.asarray, jax.jit(jeng.init_inject)(
        jcache, jnp.float32(v)))
    teng = tserve.build_decode_engine(
        TB, TCFG, tserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                                     undervolt=tplan, kv_injection="write"),
        2, static_voltage=v, device="cpu")
    got = teng.init_inject(tcache)
    changed = 0
    for name in ("k", "v", "pos"):
        r = ref["periods"]["s0_global"][name]
        g = convert.tensor_to_numpy_bits(got["periods"]["s0_global"][name])
        np.testing.assert_array_equal(g, r.view(np.uint32), err_msg=name)
        changed += int((g != np.asarray(
            jcache["periods"]["s0_global"][name]).view(np.uint32)).sum())
    assert changed > 0


def test_unported_options_raise_naming_their_slice():
    _, tp = _params()
    tplan = _plans(0.88, False)[1]
    batch = {"tokens": TOKENS}
    # the admission governor is ported; a governor of another plan is
    # refused as the reference refuses it
    with pytest.raises(ValueError, match="built from sc.undervolt"):
        tserve.generate(TB, TCFG, tp, batch, tserve.ServeConfig(
            max_len=MAX_LEN, max_new_tokens=2, undervolt=tplan,
            governor=_plans(0.88, False)[1].make_governor("kv")),
            device="cpu")
    # kv_placement= (a paged scheduler request's replay) is ported; it
    # needs the plan whose fault map addresses the placement
    with pytest.raises(ValueError, match="kv_placement override needs"):
        tserve.generate(TB, TCFG, tp, batch, tserve.ServeConfig(
            max_len=MAX_LEN, max_new_tokens=2), device="cpu",
            kv_placement=object())
    # engine='segments' is ported (K5/K6) and, as in the reference, takes
    # no voltage override; the adaptive governor is ported: an empty
    # posterior re-plans it onto the same frontier
    with pytest.raises(ValueError, match="no voltage override"):
        inject_group({}, None, None, engine="segments", voltage=0.9)
    adaptive = tplan.make_governor("kv", mode="adaptive")
    v0 = adaptive.voltage_at(1e-3)
    adaptive.replan(FaultMapPosterior(tplan.fault_map()))
    assert adaptive.replans == 1 and adaptive.voltage_at(1e-3) == v0
    # tiered placement is ported: a tiered plan covers and places the
    # cache (tests/test_torch_statearena.py holds it against the reference)
    tiered = UndervoltPlan(domains=tplan.domains, tiers={"kv_cache": "cheap"},
                           geometry=tplan.geometry)
    assert tiered.covers("kv_cache") and not tiered.covers("params")
    assert tiered.place({"kv_cache": {"x": torch.zeros(8)}})[
        "kv_cache"].domain.name == "kv"
    with pytest.raises(ValueError, match="kv_injection"):
        tserve.generate(TB, TCFG, tp, batch, tserve.ServeConfig(
            max_len=MAX_LEN, max_new_tokens=2, undervolt=tplan,
            kv_injection="bogus"), device="cpu")


def test_power_report_matches_reference():
    jplan, tplan = _plans(0.91, True)
    assert tplan.power_report(0.5) == jplan.power_report(0.5)
