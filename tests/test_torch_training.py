"""The port's training path held against the JAX reference.

The data pipeline equals the reference's on bits; AdamW, the int8
error-feedback compression, ``forward_train`` of both families (float32,
loss and gradients), one train step (microbatches 1 and 2, int8_ef) and
3-step loss trajectories (a clean and an aggressive plan) agree within
the stated tolerances, from one state converted to both packages.  The
step's undervolt injection equals the reference's ``UndervoltPlan.apply``
on raw words and counts (word, bitwise, ECC), given the same post-AdamW
words.  The attention's flash-style backward equals autograd through a
plain softmax attention.  The reference's own training checks (guardband,
sub-critical crash, governor and voltage-key controls) hold in the port.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.domains import DeviceCrashError as JCrash
from repro.core.domains import MemoryDomain as JDomain
from repro.core.hbm import TPU_V5E as JTPU
from repro.core.hbm import VCU128 as JVCU128
from repro.data import pipeline as jpipe
from repro.models.base import ArchConfig as JArch
from repro.models.base import get_arch as jget_arch
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.training import trainer as jtrainer
from repro.training import undervolt as jundervolt

from repro_torch import convert
from repro_torch.core import pytree
from repro_torch.core.domains import DeviceCrashError, MemoryDomain
from repro_torch.core.hbm import TPU_V5E, VCU128
from repro_torch.data import pipeline
from repro_torch.models import layers as L
from repro_torch.models.base import ArchConfig, get_arch
from repro_torch.optim import adamw, compress
from repro_torch.training import trainer, undervolt


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


ARCHS = ("llama3.2-3b", "recurrentgemma-9b")
ADAMW = dict(lr=3e-3, warmup_steps=10, total_steps=200)
# float32 tolerances, measured against the reference on the CPU and set
# with headroom: the loss is a mean of exact-order-free sums (XLA fuses
# and reorders), gradients are held relative to each leaf's largest
# entry, and after a step the parameters may differ by the update of
# entries whose gradient is within float noise of 0 (AdamW's m/sqrt(v)
# is +-1 for any nonzero gradient at step 1).
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
NORM_RTOL = 1e-5


def _cfgs(arch, dtype=True):
    jb, tb = jget_arch(arch), get_arch(arch)
    if not dtype:
        return jb, tb, jb.reduced, tb.reduced
    return (jb, tb, dataclasses.replace(jb.reduced, dtype=jnp.float32),
            dataclasses.replace(tb.reduced, dtype=torch.float32))


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return convert.tensor_to_numpy_bits(t).view(ml_dtypes.bfloat16)
    return t.detach().numpy().copy()


def _jax_tree(tree):
    return jax.tree.map(lambda a: jnp.asarray(a), pytree.tree_map(
        _to_numpy, tree))


@functools.lru_cache(maxsize=None)
def _init(arch, f32=True):
    """One initial train state as numpy leaves (the port's init from a
    seeded generator), given to both packages."""
    _, tb, _, tcfg = _cfgs(arch, f32)
    state = trainer.init_state(tb, tcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return pytree.tree_map(_to_numpy, state)


def _both_states(arch, f32=True):
    np_state = _init(arch, f32)
    return (jax.tree.map(jnp.asarray, np_state),
            convert.train_state_from_jax(np_state))


def _batch(vocab, step, seed=3, seq=24, batch=4):
    dc = pipeline.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch,
                             seed=seed)
    return pipeline.make_batch(dc, step)


def _f(x):
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def _rel(a, b):
    return abs(_f(a) - _f(b)) / max(abs(_f(b)), 1e-30)


# --------------------------------------------------------------- data


@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_make_batch_bit_equal(hosts):
    count, index = hosts
    kw = dict(vocab=101, seq_len=16, global_batch=8, seed=4,
              host_count=count, host_index=index)
    for step in (0, 1, 7):
        a = pipeline.make_batch(pipeline.DataConfig(**kw), step)
        b = jpipe.make_batch(jpipe.DataConfig(**kw), step)
        assert a.keys() == b.keys()
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_make_batch_extras_bit_equal(family):
    kw = dict(arch_id="x", family=family, n_layers=1, d_model=6, n_heads=1,
              n_kv_heads=1, d_ff=8, vocab=50, enc_len=3, frontend_dim=5)
    dkw = dict(vocab=50, seq_len=8, global_batch=4, seed=2)
    a = pipeline.make_batch(pipeline.DataConfig(**dkw), 5, ArchConfig(**kw))
    b = jpipe.make_batch(jpipe.DataConfig(**dkw), 5, JArch(**kw))
    assert a.keys() == b.keys() and len(a) == 2
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    it = pipeline.batch_iterator(pipeline.DataConfig(**dkw), start_step=5)
    step, first = next(it)
    assert step == 5
    np.testing.assert_array_equal(first["tokens"], a["tokens"])


# --------------------------------------------------------------- optimizer


def _opt_trees(seed=0):
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(7, 5).astype(np.float32),
              "b": {"c": rng.randn(11).astype(np.float32),
                    "d": rng.randn(3, 4).astype(ml_dtypes.bfloat16)}}
    grads = [pytree.tree_map(lambda p: (rng.randn(*p.shape) * s).astype(
        np.float32), params) for s in (0.3, 2.0, 0.01)]
    return params, grads


def test_adamw_update_matches_reference():
    """Three updates (the second clipped) from the same float32 inputs:
    parameters and moments within 1e-6 relative (bf16 parameters equal
    after rounding), norm and learning rate too."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5)
    params, grads = _opt_trees()
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jadamw.init(jp)
    tp = convert.params_from_jax(params)
    topt = adamw.init(tp)
    for g in grads:
        jp, jopt, jm = jadamw.update(jax.tree.map(jnp.asarray, g), jopt, jp,
                                     jadamw.AdamWConfig(**cfg))
        tg = convert.params_from_jax(g)
        _, _, tm = adamw.update(tg, topt, tp, adamw.AdamWConfig(**cfg))
        assert _rel(tm["grad_norm"], jm["grad_norm"]) < 1e-6
        assert _rel(tm["lr"], jm["lr"]) < 1e-6
        assert int(topt["step"]) == int(jopt["step"])
        for name, jt, tt in (("params", jp, tp), ("mu", jopt["mu"],
                                                  topt["mu"]),
                             ("nu", jopt["nu"], topt["nu"])):
            for a, b in zip(jax.tree_util.tree_leaves(jt), pytree.leaves(tt)):
                a = np.asarray(a).astype(np.float32)
                b = b.detach().float().numpy()
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-12,
                                           err_msg=name)
    assert tp["b"]["d"].dtype == torch.bfloat16


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_ratio=0.1)
    for s in (0, 1, 3, 7, 8, 20, 39, 40, 55):
        j = jadamw.schedule(jnp.int32(s), jadamw.AdamWConfig(**cfg))
        t = adamw.schedule(torch.tensor(s, dtype=torch.int32),
                           adamw.AdamWConfig(**cfg))
        assert _rel(t, j) < 1e-6, s


def test_ef_quantize_grads_bit_equal():
    """Elementwise and ordered as the reference: equal on bits over five
    rounds of error feedback."""
    _, grads = _opt_trees(1)
    g = grads[1]
    jef = jcompress.init_ef(jax.tree.map(jnp.asarray, g))
    tef = compress.init_ef(convert.params_from_jax(g))
    for _ in range(5):
        jdq, jef = jcompress.ef_quantize_grads(jax.tree.map(jnp.asarray, g),
                                               jef)
        tdq, tef = compress.ef_quantize_grads(convert.params_from_jax(g),
                                              tef)
        for a, b in zip(jax.tree_util.tree_leaves((jdq, jef)),
                        pytree.leaves((tdq, tef))):
            np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                          b.numpy().view(np.uint32))
    q, s = compress.quantize_int8(torch.tensor([0.5, -2.0, 1.0]))
    assert q.dtype == torch.int8 and q.tolist() == [32, -127, 64]
    assert float(s) == pytest.approx(2.0 / 127)


# --------------------------------------------------------------- models


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch):
    jb, _, jcfg, _ = _cfgs(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jb.module.forward_train(p, b, jcfg)[0]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    """float32: loss within 1e-5 relative, every gradient leaf within
    1e-4 of its largest entry; the dense family also with a loss mask
    (each input structure costs the reference a compile)."""
    _, tb, jcfg, tcfg = _cfgs(arch)
    jstate, tstate = _both_states(arch)
    batch = _batch(jcfg.vocab, 0)
    mask = (np.arange(23)[None, :] % 3 != 0).repeat(4, 0)
    extras = ({}, {"loss_mask": mask}) if arch == "llama3.2-3b" else ({},)
    for extra in extras:
        b = {**batch, **extra}
        jl, jg = _jax_value_and_grad(arch)(
            jstate["params"], {k: jnp.asarray(v) for k, v in b.items()})
        tl, metrics = tb.module.forward_train(
            tstate["params"], trainer.device_batch(b, "cpu"), tcfg)
        assert metrics["loss"] is tl
        assert _rel(tl, jl) < LOSS_RTOL
        tg = torch.autograd.grad(tl, pytree.leaves(tstate["params"]))
        for a, g in zip(jax.tree_util.tree_leaves(jg), tg):
            a = np.asarray(a)
            err = np.abs(g.numpy() - a).max()
            assert err <= GRAD_RTOL * max(np.abs(a).max(), 1e-30), err


def _plain_attention(q, k, v, window, causal=True):
    g = q.shape[2] // k.shape[2]
    kk, vv = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * q.shape[-1] ** -0.5
    pos = torch.arange(q.shape[1])
    delta = pos[:, None] - pos[None, :]
    masked = (delta < 0) if causal else torch.zeros_like(delta, dtype=bool)
    if window:
        masked = masked | (delta >= window)
    s = s.masked_fill(masked, L.NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)


@pytest.mark.parametrize("window,heads,kv_heads", [(0, 4, 4), (0, 6, 2),
                                                   (5, 6, 2), (9, 4, 1)])
def test_attention_vjp_matches_autograd(window, heads, kv_heads):
    """The blockwise backward (several q and kv chunks, a ragged last
    one) equals autograd through a plain softmax attention, float32."""
    gen = torch.Generator().manual_seed(window + heads)
    b, s, d = 2, 29, 8
    q = torch.randn(b, s, heads, d, generator=gen, requires_grad=True)
    k = torch.randn(b, s, kv_heads, d, generator=gen, requires_grad=True)
    v = torch.randn(b, s, kv_heads, d, generator=gen, requires_grad=True)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    out = L.attention(q, k, v, q_positions=pos, k_positions=pos,
                      window=window, q_chunk=8, kv_chunk=12)
    ref = _plain_attention(q, k, v, window)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    dout = torch.randn(out.shape, generator=gen)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        plain = L.attention(q, k, v, q_positions=pos, k_positions=pos,
                            window=window, q_chunk=8, kv_chunk=12)
    assert torch.equal(plain, out.detach())


# --------------------------------------------------------------- train step


@functools.lru_cache(maxsize=None)
def _jax_step(arch, microbatches, compression, plan_key=None):
    jb, _, jcfg, _ = _cfgs(arch)
    plan = None if plan_key is None else _plans(plan_key)[0]
    tc = jtrainer.TrainConfig(adamw=jadamw.AdamWConfig(**ADAMW),
                              microbatches=microbatches,
                              grad_compression=compression, undervolt=plan)
    return jax.jit(jtrainer.make_train_step(jb, jcfg, tc))


def _torch_step(arch, microbatches, compression, plan=None, f32=True):
    _, tb, _, tcfg = _cfgs(arch, f32)
    tc = trainer.TrainConfig(adamw=adamw.AdamWConfig(**ADAMW),
                             microbatches=microbatches,
                             grad_compression=compression, undervolt=plan)
    return trainer.make_train_step(tb, tcfg, tc)


@pytest.mark.parametrize("microbatches,compression",
                         [(1, "none"), (2, "none"), (2, "int8_ef")])
def test_train_step_matches_reference(microbatches, compression):
    """One step of the reduced llama3.2-3b (float32) from one state:
    loss, grad_norm and lr within tolerance, moments and the step
    counter too."""
    arch = "llama3.2-3b"
    jstate, tstate = _both_states(arch)
    if compression == "int8_ef":
        jstate = {**jstate, "ef": jcompress.init_ef(jstate["params"])}
        tstate["ef"] = compress.init_ef(tstate["params"])
    batch = _batch(get_arch(arch).reduced.vocab, 0)
    js, jm = _jax_step(arch, microbatches, compression)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tm = _torch_step(arch, microbatches, compression)(
        tstate, trainer.device_batch(batch, "cpu"))
    assert ts is tstate
    assert _rel(tm["loss"], jm["loss"]) < LOSS_RTOL
    assert _rel(tm["grad_norm"], jm["grad_norm"]) < NORM_RTOL
    assert _rel(tm["lr"], jm["lr"]) < 1e-6
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"]) == 1
    for a, b in zip(jax.tree_util.tree_leaves(js["opt"]["mu"]),
                    pytree.leaves(ts["opt"]["mu"])):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= GRAD_RTOL * max(
            np.abs(a).max(), 1e-30)
    if compression == "int8_ef":
        assert set(ts) == {"params", "opt", "ef"}
    assert all(p.requires_grad and p.is_leaf
               for p in pytree.leaves(ts["params"]))


def _plans(key):
    """(reference plan, port plan) pairs of the injection tests."""
    if key == "aggressive":
        return (jundervolt.aggressive_plan(v_unsafe=0.91, geometry=JVCU128),
                undervolt.aggressive_plan(v_unsafe=0.91, geometry=VCU128))
    v, ecc = {"word": (0.88, False), "bitwise": (0.86, False),
              "ecc": (0.875, True)}[key]
    pcs = tuple(range(32))

    def mk(plan_cls, dom_cls, geo):
        return plan_cls(
            domains={"cheap": dom_cls("cheap", v, pcs[8:], ecc=ecc),
                     "safe": dom_cls("safe", 0.98, pcs[:8])},
            policy={"params": "cheap", "mu": "safe", "nu": "safe"},
            geometry=geo, mitigation="none")
    return (mk(jundervolt.UndervoltPlan, JDomain, JVCU128),
            mk(undervolt.UndervoltPlan, MemoryDomain, VCU128))


@pytest.mark.parametrize("key", ["word", "bitwise", "ecc"])
def test_step_injection_matches_reference_on_words(key):
    """The step's injection of the post-AdamW words (reduced llama3.2-3b,
    bf16 parameters) equals the reference's ``UndervoltPlan.apply`` on
    the same words: raw words of params / mu / nu and the counts."""
    arch = "llama3.2-3b"
    jplan, tplan = _plans(key)
    method = {"word": "word", "bitwise": "bitwise", "ecc": "auto"}[key]
    batch = trainer.device_batch(_batch(get_arch(arch).reduced.vocab, 0),
                                 "cpu")
    np_state = _init(arch, f32=False)
    clean, _ = _torch_step(arch, 1, "none", f32=False)(
        convert.train_state_from_jax(np_state), batch)
    _, tb, _, tcfg = _cfgs(arch, False)
    tc = trainer.TrainConfig(adamw=adamw.AdamWConfig(**ADAMW),
                             undervolt=tplan, undervolt_method=method)
    faulted, m = trainer.make_train_step(tb, tcfg, tc)(
        convert.train_state_from_jax(np_state), batch)
    groups = {"params": clean["params"], "mu": clean["opt"]["mu"],
              "nu": clean["opt"]["nu"]}
    jb = jget_arch(arch)
    pspecs = jb.module.param_specs(jb.reduced)
    from repro.models.base import spec_avals
    mspecs = spec_avals(jadamw.moment_specs(pspecs))
    jplace = jplan.place({"params": spec_avals(pspecs), "mu": mspecs["mu"],
                          "nu": mspecs["nu"]})
    jout, jm = jplan.apply(_jax_tree(groups), jplace, method=method)
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


@pytest.mark.parametrize("plan_key", [None, "aggressive"])
def test_loss_trajectory_matches_reference(plan_key):
    """Three steps (float32, microbatches 2): losses within 1e-4
    relative of the reference's, for a clean and an aggressive plan."""
    arch = "llama3.2-3b"
    jstate, tstate = _both_states(arch)
    plan = None if plan_key is None else _plans(plan_key)[1]
    jstep = _jax_step(arch, 2, "none", plan_key)
    tstep = _torch_step(arch, 2, "none", plan)
    vocab = get_arch(arch).reduced.vocab
    for i in range(3):
        batch = _batch(vocab, i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, trainer.device_batch(batch, "cpu"))
        assert np.isfinite(float(tm["loss"]))
        assert _rel(tm["loss"], jm["loss"]) < 1e-4, i
        if plan_key is not None:
            assert int(tm["uncorrectable_faults"]) == 0


# --------------------------------------------------------------- controls


def test_guardband_training_is_faultless():
    arch = "llama3.2-3b"
    _, tstate = _both_states(arch)
    step = _torch_step(arch, 1, "none", undervolt.guardband_plan(TPU_V5E))
    batch = trainer.device_batch(_batch(get_arch(arch).reduced.vocab, 0),
                                 "cpu")
    before = [p.detach().clone() for p in pytree.leaves(tstate["params"])]
    _, m = step(tstate, batch)
    assert int(m["uncorrectable_faults"]) == 0
    assert int(m["corrected_faults"]) == 0
    assert any(not torch.equal(a, b.detach()) for a, b in zip(
        before, pytree.leaves(tstate["params"])))


def test_subcritical_voltage_crashes():
    groups = {"params": {}, "mu": {}, "nu": {}}
    policy = {"params": "d", "mu": "d", "nu": "d"}
    with pytest.raises(JCrash):
        jundervolt.UndervoltPlan(domains={"d": JDomain("d", 0.79, (0,))},
                                 policy=policy, geometry=JTPU).place(groups)
    with pytest.raises(DeviceCrashError):
        undervolt.UndervoltPlan(domains={"d": MemoryDomain("d", 0.79, (0,))},
                                policy=policy, geometry=TPU_V5E).place(groups)


def test_governor_checks_raise_like_reference():
    arch = "llama3.2-3b"
    for pkg, mk_plan, geo, tr, b, cfg in (
            (jundervolt, jundervolt.aggressive_plan, JVCU128, jtrainer,
             jget_arch(arch), jget_arch(arch).reduced),
            (undervolt, undervolt.aggressive_plan, VCU128, trainer,
             get_arch(arch), get_arch(arch).reduced)):
        plan = mk_plan(v_unsafe=0.91, geometry=geo)
        other = mk_plan(v_unsafe=0.90, geometry=geo)
        gov = plan.make_governor("cheap", tolerable_rate=1e-3)
        ad = (jadamw if tr is jtrainer else adamw).AdamWConfig(**ADAMW)
        with pytest.raises(ValueError):
            tr.make_train_step(b, cfg, tr.TrainConfig(
                adamw=ad, undervolt=other, governor=gov,
                undervolt_method="word"))
        with pytest.raises(ValueError):
            tr.make_train_step(b, cfg, tr.TrainConfig(
                adamw=ad, undervolt=plan, governor=gov,
                undervolt_voltage_key="hbm_v", undervolt_method="word"))
        with pytest.raises(ValueError, match="undervolt_method"):
            tr.make_train_step(b, cfg, tr.TrainConfig(
                adamw=ad, undervolt=plan, governor=gov))


def test_governed_and_keyed_voltage_steer_the_step():
    """The governor's setpoint and the voltage key move the step's
    voltage (the reference's governor and voltage-key tests, in the
    port): a guardband setting gives the same words twice, a deep one
    other words; governor_voltage follows the setpoint as the
    reference's governor maps it."""
    arch = "llama3.2-3b"
    _, tb, _, tcfg = _cfgs(arch)
    plan = undervolt.aggressive_plan(v_unsafe=0.91, mitigation="none",
                                     geometry=VCU128)
    jplan = jundervolt.aggressive_plan(v_unsafe=0.91, mitigation="none",
                                       geometry=JVCU128)
    gov = plan.make_governor("cheap", mode="power", tolerable_rate=1e-3)
    jgov = jplan.make_governor("cheap", mode="power", tolerable_rate=1e-3)
    batch = trainer.device_batch(_batch(tcfg.vocab, 0), "cpu")
    for tc, key, settings in (
            (trainer.TrainConfig(adamw=adamw.AdamWConfig(**ADAMW),
                                 undervolt=plan, governor=gov,
                                 governor_key="power_budget",
                                 undervolt_method="word"),
             "power_budget", (1.0, 1.0, 0.55)),
            (trainer.TrainConfig(adamw=adamw.AdamWConfig(**ADAMW),
                                 undervolt=plan,
                                 undervolt_voltage_key="hbm_v"),
             "hbm_v", (0.98, 0.98, 0.88))):
        step = trainer.make_train_step(tb, tcfg, tc)
        runs = []
        for s in settings:
            st, m = step(convert.train_state_from_jax(_init(arch)),
                         {**batch, key: s})
            runs.append([p.detach() for p in pytree.leaves(st["params"])])
            if tc.governor is not None:
                assert m["governor_voltage"] == pytest.approx(
                    float(jgov.voltage_at(jnp.float32(s))), abs=0)
        assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
        assert any(not torch.equal(a, b) for a, b in zip(runs[0], runs[2]))


def test_eval_loss_and_state_specs():
    arch = "recurrentgemma-9b"
    jb, tb, jcfg, tcfg = _cfgs(arch)
    _, tstate = _both_states(arch)
    batch = trainer.device_batch(_batch(tcfg.vocab, 1), "cpu")
    loss = trainer.make_eval_loss(tb, tcfg)(tstate["params"], batch)
    assert not loss.requires_grad and np.isfinite(float(loss))
    tc = trainer.TrainConfig(grad_compression="int8_ef")
    specs = trainer.state_specs(tb, tcfg, tc)
    jspecs = jtrainer.state_specs(jb, jcfg, jtrainer.TrainConfig(
        grad_compression="int8_ef"))
    assert sorted(specs) == sorted(jspecs) == ["ef", "opt", "params"]
    flat = pytree.flatten_with_path(specs, is_leaf=lambda x: hasattr(
        x, "shape") and hasattr(x, "axes"))
    jflat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: hasattr(x, "axes"))[0]
    assert [pytree.keystr(p) for p, _ in flat] == [
        jax.tree_util.keystr(p) for p, _ in jflat]
    assert [tuple(s.shape) for _, s in flat] == [
        tuple(s.shape) for _, s in jflat]


def test_entry_points_default_to_the_card(monkeypatch):
    """init_state and the quickstart run on the card unless asked for the
    CPU, and raise without one rather than fall back."""
    from repro_torch.examples import quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb = get_arch("llama3.2-3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.init_state(tb, tb.reduced)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])


# --------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_k1_in_train_step_equals_plain(cuda_device):
    """On the card: the step's K1 launch (one per step) gives the words
    the plain version gives on the same post-AdamW words."""
    from repro_torch.core import engine
    from repro_torch.kernels import _build
    arch = "llama3.2-3b"
    _, tb, _, tcfg = _cfgs(arch, False)
    _, plan = _plans("word")
    batch = trainer.device_batch(_batch(tcfg.vocab, 0), cuda_device)

    def state():
        return pytree.tree_map(lambda t: t.to(cuda_device),
                               convert.train_state_from_jax(
                                   _init(arch, False)))

    clean, _ = _torch_step(arch, 1, "none", f32=False)(state(), batch)
    tc = trainer.TrainConfig(adamw=adamw.AdamWConfig(**ADAMW),
                             undervolt=plan, undervolt_method="word")
    before = _build.launch_counts().get("arena_bitflip", 0)
    got, _ = trainer.make_train_step(tb, tcfg, tc)(state(), batch)
    assert _build.launch_counts()["arena_bitflip"] - before == 1
    placement = trainer._placements(tb, tcfg, tc)["params"]
    params = pytree.tree_map(lambda p: p.detach(), clean["params"])
    want, _ = engine.inject_placement(params, placement, plan.fault_map(),
                                      method="word", use_ref=True)
    for a, b in zip(pytree.leaves(got["params"]), pytree.leaves(want)):
        assert torch.equal(a.detach().view(torch.int16),
                           b.view(torch.int16))
