"""The port's DeepSeek-V2 training path (``models/moe.py::forward_train``
through ``training/trainer.py``) held against the reference.

The reduced configs in float32 start both packages from one reference
init, converted by :mod:`repro_torch.convert`.  The loss and its parts
agree within 1e-5 relative, every gradient leaf within 1e-4 + 1e-4 |ref|,
at a capacity that drops tokens and one that does not, and the dropped
(token, choice) pairs are the same.  Two AdamW steps land the parameters
within 1e-5 + 1e-5 |ref| of the reference trainer's.  With bf16
parameters beside the float32 router, a plan at ``V_MIN`` equals no plan
on bits, and the step's injection of the packed MoE leaves equals the
reference's ``UndervoltPlan.apply`` on raw words with one arena pass per
unsafe group.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.domains import MemoryDomain as JDomain
from repro.core.hbm import VCU128 as JVCU128
from repro.models import moe as jmoe
from repro.models.base import get_arch as jget_arch
from repro.models.base import spec_avals as jspec_avals
from repro.optim import adamw as jadamw
from repro.training import trainer as jtrainer
from repro.training import undervolt as jundervolt

from repro_torch import convert
from repro_torch.core import engine, pytree
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.faultmodel import V_MIN
from repro_torch.core.hbm import VCU128
from repro_torch.data import pipeline
from repro_torch.models import moe
from repro_torch.models.base import get_arch
from repro_torch.optim import adamw
from repro_torch.training import trainer, undervolt

LITE = "deepseek-v2-lite-16b"
ADAMW = dict(lr=3e-3, warmup_steps=10, total_steps=200)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, f32=True, **kw):
    jb, tb = jget_arch(arch), get_arch(arch)
    jcfg, tcfg = jb.reduced, tb.reduced
    if f32:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return (jb, tb, dataclasses.replace(jcfg, **kw),
            dataclasses.replace(tcfg, **kw))


@functools.lru_cache(maxsize=None)
def _init(arch, f32=True):
    """The reference's initial train state, as numpy leaves."""
    jb, _, jcfg, _ = _cfgs(arch, f32)
    state = jtrainer.init_state(jb, jcfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state)


def _both_states(arch, f32=True):
    np_state = _init(arch, f32)
    return (jax.tree.map(jnp.asarray, np_state),
            convert.train_state_from_jax(np_state))


def _batch(vocab, step, seq=12, batch=4):
    dc = pipeline.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                             seed=3)
    return pipeline.make_batch(dc, step)


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def _kept_pairs_reference(top_e, n_experts, cap):
    """The reference's dispatch (``moe_ffn``'s ``local_fn`` on one shard):
    the set of kept (token, choice) flat indices."""
    fe = jnp.asarray(top_e).reshape(-1)
    order = jnp.argsort(fe)
    se = fe[order]
    rank = jnp.arange(fe.shape[0]) - jnp.searchsorted(se, se, side="left")
    kept = np.asarray(order)[np.asarray(rank < cap)]
    return set(kept.tolist())


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cf):
    jb, _, jcfg, _ = _cfgs(LITE, capacity_factor=cf)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jb.module.forward_train(p, b, jcfg), has_aux=True))


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["no-drops", "drops"])
def test_forward_train_matches_reference(cf):
    """float32 deepseek-v2-lite reduced: loss, xent and router_aux within
    1e-5 relative, every gradient leaf within 1e-4 + 1e-4 |ref|; at the
    first MoE layer's input the kept (token, choice) pairs are the
    reference's, and capacity 0.5 drops some."""
    _, tb, jcfg, tcfg = _cfgs(LITE, capacity_factor=cf)
    jstate, tstate = _both_states(LITE)
    batch = _batch(jcfg.vocab, 0)
    (jl, jm), jg = _jax_value_and_grad(cf)(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = tb.module.forward_train(
        tstate["params"], trainer.device_batch(batch, "cpu"), tcfg)
    assert tm["loss"] is tl
    for key in ("loss", "xent", "router_aux"):
        assert _rel(tm[key].detach(), jm[key]) < LOSS_RTOL, key
    tg = torch.autograd.grad(tl, pytree.leaves(tstate["params"]))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jg)[0]]
    for path, a, g in zip(paths, jax.tree_util.tree_leaves(jg), tg):
        a = np.asarray(a)
        excess = np.abs(g.numpy() - a) - GRAD_TOL * np.abs(a)
        assert excess.max() <= GRAD_TOL, (path, excess.max())

    # the dispatch at the training capacity, on one layer's input
    layer = {k: v[0] for k, v in
             tstate["params"]["stack"]["periods"]["s0_moe"].items()}
    x = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (4, 12, tcfg.d_model)).astype(np.float32))
    probs = torch.softmax(x @ layer["w_router"].detach(), -1)
    _, top_e = moe._top_k(probs, tcfg.top_k)
    _, jtop_e = jax.lax.top_k(jnp.asarray(probs.numpy()), jcfg.top_k)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity(tcfg, t, decode=False)
    assert cap == max(1, int(np.ceil(cf * t * tcfg.top_k / tcfg.n_experts)))
    order, slot = moe.dispatch(top_e, tcfg.n_experts, cap)
    kept = set(order[slot < tcfg.n_experts * cap].tolist())
    assert kept == _kept_pairs_reference(jtop_e, jcfg.n_experts, cap)
    assert (len(kept) < t * tcfg.top_k) == (cf < 1.0)


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    jb, _, jcfg, _ = _cfgs(arch)
    tc = jtrainer.TrainConfig(adamw=jadamw.AdamWConfig(**ADAMW))
    return jax.jit(jtrainer.make_train_step(jb, jcfg, tc))


@pytest.mark.parametrize("arch", [LITE, "deepseek-v2-236b"])
def test_two_train_steps_match_reference(arch):
    """Two make_train_step steps with AdamW (float32; 236b: the q-LoRA
    query path): losses within 1e-5 relative, parameters within 1e-5 +
    1e-5 |ref| of the reference trainer's."""
    _, tb, jcfg, tcfg = _cfgs(arch)
    jstate, tstate = _both_states(arch)
    tstep = trainer.make_train_step(tb, tcfg, trainer.TrainConfig(
        adamw=adamw.AdamWConfig(**ADAMW)))
    for i in range(2):
        batch = _batch(jcfg.vocab, i)
        jstate, jm = _jax_step(arch)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tm = tstep(tstate, trainer.device_batch(batch, "cpu"))
        assert _rel(tm["loss"], jm["loss"]) < LOSS_RTOL, i
        assert _rel(tm["router_aux"], jm["router_aux"]) < LOSS_RTOL, i
    assert int(tstate["opt"]["step"]) == 2
    for a, b in zip(jax.tree_util.tree_leaves(jstate["params"]),
                    pytree.leaves(tstate["params"])):
        a = np.asarray(a)
        excess = np.abs(b.detach().numpy() - a) - PARAM_TOL * np.abs(a)
        assert excess.max() <= PARAM_TOL, excess.max()


def _plans(key):
    """(reference plan, port plan): parameters (bf16 beside the float32
    router) on an unsafe domain, the moments guardband-safe."""
    v, ecc = {"word": (0.88, False), "ecc": (0.875, True),
              "vmin": (V_MIN, False)}[key]
    pcs = tuple(range(32))

    def mk(plan_cls, dom_cls, geo):
        return plan_cls(
            domains={"cheap": dom_cls("cheap", v, pcs[8:], ecc=ecc),
                     "safe": dom_cls("safe", 0.98, pcs[:8])},
            policy={"params": "cheap", "mu": "safe", "nu": "safe"},
            geometry=geo, mitigation="none")
    return (mk(jundervolt.UndervoltPlan, JDomain, JVCU128),
            mk(undervolt.UndervoltPlan, MemoryDomain, VCU128))


def _passes(monkeypatch):
    """Count the arena passes (K1, K2) of the step's injection."""
    counts = {"arena_bitflip": 0, "arena_ecc": 0}
    for name in counts:
        fn = getattr(engine, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(engine, name, counted)
    return counts


def _bf16_step(plan=None, method="auto"):
    _, tb, _, tcfg = _cfgs(LITE, f32=False)
    return trainer.make_train_step(tb, tcfg, trainer.TrainConfig(
        adamw=adamw.AdamWConfig(**ADAMW), undervolt=plan,
        undervolt_method=method))


def test_plan_at_vmin_equals_no_plan(monkeypatch):
    """bf16 parameters, two steps: a plan whose unsafe domain sits at
    V_MIN runs no arena pass and leaves the state equal, on bits, to the
    run with no plan."""
    vocab = get_arch(LITE).reduced.vocab
    states = []
    counts = _passes(monkeypatch)
    for plan in (None, _plans("vmin")[1]):
        state = convert.train_state_from_jax(_init(LITE, f32=False))
        step = _bf16_step(plan)
        for i in range(2):
            state, m = step(state, trainer.device_batch(_batch(vocab, i),
                                                        "cpu"))
        states.append(state)
    assert counts == {"arena_bitflip": 0, "arena_ecc": 0}
    assert int(m["uncorrectable_faults"]) == 0
    for a, b in zip(pytree.leaves(states[0]), pytree.leaves(states[1])):
        np.testing.assert_array_equal(convert.tensor_to_numpy_bits(a),
                                      convert.tensor_to_numpy_bits(b))


@pytest.mark.parametrize("key", ["word", "ecc"])
def test_step_injection_matches_reference_on_words(key, monkeypatch):
    """The step's injection of the post-AdamW MoE state (the float32
    router packed with bf16 expert weights in the parameter arena)
    equals the reference's ``UndervoltPlan.apply`` on the same words: raw
    words of params / mu / nu and the counts.  One arena pass (K1, or K2
    under ECC) per unsafe group and step."""
    jplan, tplan = _plans(key)
    method = "word" if key == "word" else "auto"
    batch = trainer.device_batch(_batch(get_arch(LITE).reduced.vocab, 0),
                                 "cpu")
    clean, _ = _bf16_step()(convert.train_state_from_jax(
        _init(LITE, f32=False)), batch)
    counts = _passes(monkeypatch)
    faulted, m = _bf16_step(tplan, method)(convert.train_state_from_jax(
        _init(LITE, f32=False)), batch)
    assert counts == ({"arena_bitflip": 1, "arena_ecc": 0} if key == "word"
                      else {"arena_bitflip": 0, "arena_ecc": 1})
    groups = {"params": clean["params"], "mu": clean["opt"]["mu"],
              "nu": clean["opt"]["nu"]}
    router = groups["params"]["stack"]["periods"]["s0_moe"]["w_router"]
    assert router.dtype == torch.float32
    assert groups["params"]["stack"]["periods"]["s0_moe"]["we_g"].dtype \
        == torch.bfloat16
    jb = jget_arch(LITE)
    pspecs = jb.module.param_specs(jb.reduced)
    mspecs = jspec_avals(jadamw.moment_specs(pspecs))
    jplace = jplan.place({"params": jspec_avals(pspecs),
                          "mu": mspecs["mu"], "nu": mspecs["nu"]})

    def as_jax(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(convert.tensor_to_numpy_bits(t).view(
                ml_dtypes.bfloat16))
        return jnp.asarray(t.detach().numpy().copy())

    jout, jm = jplan.apply(pytree.tree_map(as_jax, groups), jplace,
                           method=method)
    got = {"params": faulted["params"], "mu": faulted["opt"]["mu"],
           "nu": faulted["opt"]["nu"]}
    changed = 0
    for name in got:
        for a, b, c in zip(jax.tree_util.tree_leaves(jout[name]),
                           pytree.leaves(got[name]),
                           pytree.leaves(groups[name])):
            raw = convert.tensor_to_numpy_bits(b)
            np.testing.assert_array_equal(
                raw, np.asarray(a).view(raw.dtype), err_msg=name)
            changed += int((raw != convert.tensor_to_numpy_bits(c)).sum())
    assert changed > 0
    assert int(m["uncorrectable_faults"]) == int(jm["uncorrectable_faults"])
    assert int(m["corrected_faults"]) == int(jm["corrected_faults"])
    if key == "ecc":
        assert int(m["corrected_faults"]) > 0


def test_eval_loss_has_no_graph():
    """make_eval_loss over the MoE family: the forward_train loss, no
    autograd graph."""
    _, tb, jcfg, tcfg = _cfgs(LITE)
    _, tstate = _both_states(LITE)
    batch = trainer.device_batch(_batch(jcfg.vocab, 0), "cpu")
    loss = trainer.make_eval_loss(tb, tcfg)(tstate["params"], batch)
    want, _ = moe.forward_train(tstate["params"], batch, tcfg)
    assert not loss.requires_grad
    assert float(loss) == float(want.detach())


def test_reference_aux_coefficient():
    assert moe.ROUTER_AUX_COEF == jmoe.ROUTER_AUX_COEF
