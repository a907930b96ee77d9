"""The port's xLSTM family (``models/xlstm.py``) held against the JAX
reference, on the reduced xlstm-350m config in float32.

Weights are made with numpy from a seed (the reference's init rules) and
handed to both packages.  The chunked mLSTM across a chunk boundary, its
one-token decode step, the sLSTM scan, prefill and decode logits and the
carried state agree within 1e-5 (relative to the largest magnitude);
greedy ``generate()`` tokens equal the reference's clean, at 0.86 V with
bitwise write-path injection and at 0.875 V with ECC; the write path's
whole-leaf injection of the state equals the reference's on raw uint32
words; ``forward_train`` loss and gradients agree.  Inside the port,
every request the state-arena scheduler serves equals its solo replay,
one step per scheduler is traced, and the reference's zoo-serving checks
for this family hold.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core.domains import MemoryDomain as JDomain
from repro.core.hbm import VCU128 as JVCU128
from repro.models import base as jbase
from repro.models import xlstm as jxlstm
from repro.serving import engine as jserve
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core import engine, pytree
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.hbm import VCU128
from repro_torch.models import base, xlstm
from repro_torch.serving import readpath
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.serving.statearena import StateArenaScheduler
from repro_torch.training.undervolt import (UndervoltPlan, aggressive_plan,
                                            tiered_plan)

RTOL = 1e-5
# float32 gradients, held relative to each leaf's largest entry (XLA
# fuses and reorders the chunk sums)
GRAD_RTOL = 1e-4
MAX_LEN, NEW = 32, 6
NAME = "xlstm-350m"
JB, TB = jbase.get_arch(NAME), base.get_arch(NAME)
JCFG = dataclasses.replace(JB.reduced, dtype=jnp.float32)
TCFG = dataclasses.replace(TB.reduced, dtype=torch.float32)
TOKENS = np.random.RandomState(0).randint(0, JCFG.vocab, (2, 9)).astype(
    np.int32)


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
    """(JAX tree, torch tree) of one numpy init (the reference's rules)."""
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


def _plan(v, ecc=False):
    return UndervoltPlan(
        domains={"kv": MemoryDomain("kv", v, tuple(range(32)), ecc=ecc)},
        policy={"kv_cache": "kv"}, geometry=VCU128)


def _plans(v, ecc):
    """(reference plan, port plan): the KV domain on every VCU128 PC."""
    return (JPlan(domains={"kv": JDomain("kv", v, tuple(range(32)),
                                         ecc=ecc)},
                  policy={"kv_cache": "kv"}, geometry=JVCU128),
            _plan(v, ecc))


def _close(got, want, what, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, (what, err)


def _leaves(tree):
    return {pytree.keystr(p): x for p, x in pytree.flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, base.ParamSpec))}


def _jleaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jbase.ParamSpec))[0]
    return {jax.tree_util.keystr(p): x for p, x in flat}


def test_config_and_layouts_match_reference():
    """CFG and REDUCED field for field; cache layouts, slot and batch axes
    and the parameter tree equal the reference's; every cache leaf is
    carried state."""
    for want, got in ((JB.cfg, TB.cfg), (JB.reduced, TB.reduced)):
        for f in dataclasses.fields(got):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if f.name == "dtype":
                assert str(b).rsplit(".", 1)[-1] == jnp.dtype(a).name
            else:
                assert a == b, (f.name, a, b)
    jspecs = JB.module.cache_specs(JCFG, 3, MAX_LEN)
    tspecs = TB.module.cache_specs(TCFG, 3, MAX_LEN)
    js, ts = _jleaves(jspecs), _leaves(tspecs)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].shape == ts[k].shape and js[k].axes == ts[k].axes, k
    for jfn, tfn in ((jbase.cache_slot_axes, base.cache_slot_axes),
                     (jbase.cache_batch_axes, base.cache_batch_axes)):
        assert _jleaves(jfn(jspecs)) == _leaves(tfn(tspecs))
    lay = _leaves(base.cache_layouts(tspecs, MAX_LEN))
    assert lay == _jleaves(jbase.cache_layouts(jspecs, MAX_LEN))
    assert set(lay.values()) == {"state"}
    assert {k.split("']['")[-1] for k in lay} == {
        "mem']", "norm']", "conv']", "h']", "c']", "n']", "m']"}
    assert _jleaves(JB.module.param_specs(JCFG)).keys() == _leaves(
        TB.module.param_specs(TCFG)).keys()


def _gates(rng, shape):
    return (1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))).astype(
        np.float32)


@pytest.mark.parametrize("s", [130, 1], ids=["chunk-boundary", "one-token"])
def test_mlstm_chunked_matches_reference(s):
    """The chunked mLSTM over 130 steps (two chunks, the second padded)
    and over one (the reference's padded decode chunk) from a nonzero
    memory; the port's one-token step equals its padded chunk."""
    rng = np.random.RandomState(1)
    b, h, dh = 2, 3, 8
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    i_g, f_g = _gates(rng, (b, s, h)), _gates(rng, (b, s, h))
    mem0 = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    n0 = rng.standard_normal((b, h, dh)).astype(np.float32)
    want = jax.jit(jxlstm._mlstm_chunked)(
        *(jnp.asarray(a) for a in (q, k, v, i_g, f_g, mem0, n0)))
    got = xlstm._mlstm_chunked(
        *(torch.from_numpy(a) for a in (q, k, v, i_g, f_g, mem0, n0)))
    for g, w, what in zip(got, want, ("out", "mem", "n")):
        _close(g.numpy(), w, f"mlstm {what}")
    if s == 1:
        for bi in range(b):
            step = xlstm._mlstm_step(
                *(torch.from_numpy(a[bi, 0]) for a in (q, k, v, i_g, f_g)),
                torch.from_numpy(mem0[bi]), torch.from_numpy(n0[bi]))
            for g, w, what in zip(step, (got[0][bi, 0], got[1][bi],
                                         got[2][bi]), ("out", "mem", "n")):
                _close(g.numpy(), w.numpy(), f"step {what}", 1e-6)


def test_slstm_scan_matches_reference():
    """The stabilised sLSTM recurrence over 7 steps from a nonzero state
    (per-row products, the serving route, and batched, training's)."""
    rng = np.random.RandomState(2)
    b, s, d, h = 3, 7, 16, 4
    xs = [rng.standard_normal((b, s, d)).astype(np.float32)
          for _ in range(4)]
    p = {f"r_{g}": rng.standard_normal((h, d // h, d // h)).astype(
        np.float32) * 0.5 for g in "zifo"}
    state = {k: rng.standard_normal((b, d)).astype(np.float32)
             for k in "hcn"}
    state["m"] = np.zeros((b, d), np.float32)
    jhs, jst = jax.jit(lambda xs_, p_, st_: jxlstm._slstm_scan(
        *xs_, p_, st_, h))([jnp.asarray(x) for x in xs],
                           {k: jnp.asarray(x) for k, x in p.items()},
                           {k: jnp.asarray(x) for k, x in state.items()})
    tp = {k: torch.from_numpy(x) for k, x in p.items()}
    for per_row in (True, False):
        ths, tst = xlstm._slstm_scan(
            *(torch.from_numpy(x) for x in xs), tp,
            {k: torch.from_numpy(x) for k, x in state.items()}, h,
            per_row=per_row)
        _close(ths.numpy(), jhs, "slstm hs")
        for k in "hcnm":
            _close(tst[k].numpy(), jst[k], f"slstm {k}")


def test_prefill_and_decode_match_reference():
    """Whole-model prefill logits and state (a prompt of 9 tokens), then
    two decode steps' logits and state."""
    jp, tp = _params()
    jl, jc = jax.jit(lambda p_, t_: JB.module.prefill(
        p_, {"tokens": t_}, JCFG, MAX_LEN))(jp, jnp.asarray(TOKENS))
    tl, tc = TB.module.prefill(tp, {"tokens": torch.from_numpy(TOKENS).long()},
                               TCFG, MAX_LEN)
    _close(tl.numpy(), jl, "prefill logits")
    step = jax.jit(lambda p_, c_, t_, pos: JB.module.decode_step(
        p_, c_, {"tokens": t_}, pos, JCFG))
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for i in range(2):
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(9 + i))
        tl, tc = TB.module.decode_step(tp, tc, {"tokens": torch.from_numpy(
            tok).long()}, 9 + i, TCFG)
        _close(tl.numpy(), jl, f"decode {i} logits")
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    jleaves, tleaves = _jleaves(jc), _leaves(tc)
    for k, want in jleaves.items():
        _close(tleaves[k].numpy(), want, f"state {k}")


@pytest.mark.parametrize("v,ecc,method", [(None, False, "auto"),
                                          (0.86, False, "bitwise"),
                                          (0.875, True, "auto")],
                         ids=["clean", "0.86-bitwise", "0.875-ecc"])
def test_generate_matches_reference(v, ecc, method):
    """Greedy generate() tokens equal the reference's; injected runs
    through 'auto' (== 'write': no read path) and 'rewrite'."""
    jp, tp = _params()
    jplan, tplan = (None, None) if v is None else _plans(v, ecc)
    want = np.asarray(jserve.generate(
        JB, JCFG, jp, {"tokens": jnp.asarray(TOKENS)},
        jserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                           undervolt=jplan, kv_method=method)))
    modes = ("auto",) if v is None else ("auto", "rewrite")
    for mode in modes:
        got = generate(TB, TCFG, tp, {"tokens": TOKENS}, ServeConfig(
            max_len=MAX_LEN, max_new_tokens=NEW, undervolt=tplan,
            kv_injection=mode, kv_method=method), device="cpu")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=mode)


def test_state_write_path_injection_matches_reference_on_words():
    """The step's write-path injection corrupts every state leaf whole,
    equal to the reference's ``inject_placement_slice`` on raw uint32
    words (word method, 0.84 V) and idempotent; a prefilled state from
    the model, so the words are the family's own."""
    jspecs = JB.module.cache_specs(JCFG, 1, MAX_LEN)
    tspecs = TB.module.cache_specs(TCFG, 1, MAX_LEN)
    jplan, tplan = _plans(0.84, False)
    jplc = jplan.place({"kv_cache": jbase.spec_avals(jspecs)})["kv_cache"]
    tplc = tplan.place({"kv_cache": base.spec_avals(tspecs)})["kv_cache"]
    _, tp = _params()
    _, state = TB.module.prefill(tp, {"tokens": torch.from_numpy(
        TOKENS[:1]).long()}, TCFG, MAX_LEN)
    words = {k: convert.tensor_to_numpy_bits(x).copy()
             for k, x in _leaves(state).items()}
    jtree = jax.tree_util.tree_map(lambda x: x, jbase.spec_avals(jspecs))
    flat = [(p, jnp.asarray(words[jax.tree_util.keystr(p)].view(np.float32)
                            if np.dtype(a.dtype) == np.float32 else
                            words[jax.tree_util.keystr(p)].view(a.dtype)))
            for p, a in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    jtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jtree), [x for _, x in flat])
    jstep, _ = jax.jit(lambda t: jengine.inject_placement_slice(
        t, jplc, jplan.fault_map(), slot_axes=jbase.cache_slot_axes(jspecs),
        pos=jnp.int32(9), voltage=jnp.float32(0.84), method="word"))(jtree)
    jstep = _jleaves(jax.tree.map(np.asarray, jstep))
    slot_axes = base.cache_slot_axes(tspecs)
    kw = dict(slot_axes=slot_axes, voltage=0.84, method="word")
    engine.inject_placement_slice(state, tplc, tplan.fault_map(), pos=9, **kw)
    got = {k: convert.tensor_to_numpy_bits(x).copy()
           for k, x in _leaves(state).items()}
    engine.inject_placement_slice(state, tplc, tplan.fault_map(), pos=10,
                                  **kw)
    changed = 0
    for k, g in got.items():
        np.testing.assert_array_equal(g, jstep[k].view(g.dtype), err_msg=k)
        np.testing.assert_array_equal(
            convert.tensor_to_numpy_bits(_leaves(state)[k]), g, err_msg=k)
        changed += int((g != words[k]).sum())
    assert changed > 0, "no state word faulted at 0.84 V: vacuous"
    assert set(readpath.state_leaf_paths(tspecs, MAX_LEN)) == set(got)


# ---------------------------------------------------------------------------
# the state-arena scheduler
# ---------------------------------------------------------------------------


def _requests(n=3, seed=4):
    rng = np.random.RandomState(seed)
    return [(f"r{i}", rng.randint(0, JCFG.vocab, (4 + 3 * i,)), 3 + i)
            for i in range(n)]


def _serve_and_replay(sc, reqs, num_slots=2):
    _, tp = _params()
    sched = ContinuousBatchingScheduler(TB, TCFG, tp, sc,
                                        num_slots=num_slots, device="cpu")
    assert isinstance(sched, StateArenaScheduler)
    for rid, toks, n in reqs:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
    res = sched.run()
    assert sched.stats["decode_traces"] == 1
    for rid, toks, n in reqs:
        ref = generate(TB, TCFG, tp, {"tokens": toks[None]},
                       dataclasses.replace(sc, max_new_tokens=n),
                       device="cpu", kv_placement=res[rid].placement)
        np.testing.assert_array_equal(res[rid].tokens, ref.numpy(), rid)
    return sched, res


@pytest.mark.parametrize("v", [None, 0.86], ids=["clean", "0.86-write"])
def test_state_arena_requests_equal_their_replays(v):
    """Two slots, three overlapping requests: each equals its solo
    generate(kv_placement=) replay; the route, layouts and counters."""
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=4,
                     undervolt=None if v is None else _plan(v),
                     kv_injection="write", kv_method="bitwise")
    sched, _ = _serve_and_replay(sc, _requests())
    st = sched.stats
    assert st["route"] == "state" and st["cache_layouts"] == ["state"]
    assert st["admitted"] == 3 and st["prefill_reuse"] == 0


def test_state_tier_default_fault_tolerant():
    """On a tiered plan the per-slot states land on the ``cheap`` tier by
    default, and the request still replays bit-exactly (the reference's
    test of the same name)."""
    plan = tiered_plan(v_unsafe=0.86, geometry=VCU128)
    assert plan.tiers is not None
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=3, undervolt=plan,
                     kv_injection="write", kv_method="bitwise")
    sched, _ = _serve_and_replay(sc, _requests(n=1))
    assert sched.state_tier == "cheap"
    assert all(p is not None for p in sched.placements)


def test_expert_probe_rejected_off_moe():
    _, tp = _params()
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=2,
                     undervolt=aggressive_plan(v_unsafe=0.86),
                     kv_injection="write", kv_method="bitwise")
    with pytest.raises(ValueError, match="MoE-only"):
        ContinuousBatchingScheduler(TB, TCFG, tp, sc, num_slots=1,
                                    device="cpu", expert_probe=np.arange(8))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_forward_train_matches_reference():
    """float32 loss within 1e-5 relative and every gradient leaf within
    1e-4 of its largest entry, over 2 x 140 tokens (two mLSTM chunks)."""
    jp, tp = _params()
    toks = np.random.RandomState(5).randint(0, JCFG.vocab, (2, 140))
    jl, jg = jax.jit(jax.value_and_grad(lambda p_, t_: JB.module.forward_train(
        p_, {"tokens": t_}, JCFG)[0]))(jp, jnp.asarray(toks))
    tp = pytree.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tl, metrics = TB.module.forward_train(
        tp, {"tokens": torch.from_numpy(toks)}, TCFG)
    assert metrics["loss"] is tl
    _close(tl.detach().numpy(), jl, "loss")
    grads = torch.autograd.grad(tl, pytree.leaves(tp))
    for (path, a), g in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            grads):
        _close(g.numpy(), a, jax.tree_util.keystr(path), GRAD_RTOL)
