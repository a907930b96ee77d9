"""The port's recurrent-state hybrid family (recurrentgemma) held against the
JAX reference.

The reduced recurrentgemma-9b config in float32, weights converted from
the reference's init: cache layouts, slot and batch axes and the carried
``state`` leaves equal the reference's; prefill logits and caches agree
within 1e-5 for a prompt inside the local window and one past it (the
port's scan walks the recurrence step by step where the reference runs
an associative scan, and K7's plain version materializes the softmax);
greedy ``generate()`` tokens equal the reference's clean, at 0.86 V with
bitwise write-path injection and at 0.875 V with ECC, and inside the port
'write' equals 'rewrite'.  Write-path injection of carried state is the
reference's persistent-fault semantic on raw uint32 bits.
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
from repro.serving import engine as jserve
from repro.serving import readpath as jreadpath
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core import engine, pytree
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.hbm import VCU128
from repro_torch.core.injection import inject_group
from repro_torch.models import base
from repro_torch.serving import engine as tserve
from repro_torch.serving import readpath
from repro_torch.training.undervolt import UndervoltPlan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JB, TB = jbase.get_arch("recurrentgemma-9b"), base.get_arch("recurrentgemma-9b")
JCFG = dataclasses.replace(JB.reduced, dtype=jnp.float32)
TCFG = dataclasses.replace(TB.reduced, dtype=torch.float32)
MAX_LEN, NEW = 32, 8
# 11 tokens: past the reduced config's local window of 8
TOKENS = np.random.RandomState(0).randint(0, JCFG.vocab, (2, 11)).astype(
    np.int32)


def _plans(v, ecc):
    pcs = tuple(range(32))
    return (JPlan(domains={"kv": JDomain("kv", v, pcs, ecc=ecc)},
                  policy={"kv_cache": "kv"}, geometry=JVCU128),
            UndervoltPlan(domains={"kv": MemoryDomain("kv", v, pcs, ecc=ecc)},
                          policy={"kv_cache": "kv"}, geometry=VCU128))


@functools.lru_cache(maxsize=None)
def _params():
    jp = jbase.init_params(JB.module.param_specs(JCFG), jax.random.PRNGKey(0))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp))


def _leaves(tree):
    return {pytree.keystr(p): leaf for p, leaf in pytree.flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, base.ParamSpec))}


def _jleaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jbase.ParamSpec))[0]
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


def test_cache_layouts_match_jax():
    jspecs = JB.module.cache_specs(JCFG, 3, MAX_LEN)
    tspecs = TB.module.cache_specs(TCFG, 3, MAX_LEN)
    js, ts = _jleaves(jspecs), _leaves(tspecs)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].shape == ts[k].shape and js[k].axes == ts[k].axes, k
        assert np.dtype(js[k].dtype).itemsize == ts[k].dtype.itemsize, k
    for jfn, tfn in ((jbase.cache_slot_axes, base.cache_slot_axes),
                     (jbase.cache_batch_axes, base.cache_batch_axes)):
        assert _jleaves(jfn(jspecs)) == _leaves(tfn(tspecs))
    assert _jleaves(jbase.cache_layouts(jspecs, MAX_LEN)) == _leaves(
        base.cache_layouts(tspecs, MAX_LEN))
    state = readpath.state_leaf_paths(tspecs, MAX_LEN)
    assert state == jreadpath.state_leaf_paths(jspecs, MAX_LEN)
    assert {p.split("']['")[-1] for p in state} == {"h']", "conv']"}
    assert _jleaves(JB.module.param_specs(JCFG)).keys() == _leaves(
        TB.module.param_specs(TCFG)).keys()


@pytest.mark.parametrize("s", [4, 11])
def test_prefill_matches_jax(s):
    jp, tp = _params()
    toks = TOKENS[:, :s]
    jl, jc = jax.jit(lambda p, t: JB.module.prefill(
        p, {"tokens": t}, JCFG, MAX_LEN))(jp, jnp.asarray(toks))
    tl, tc = TB.module.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                               TCFG, MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    jleaves, tleaves = _jleaves(jc), _leaves(tc)
    assert sorted(jleaves) == sorted(tleaves)
    for k, want in jleaves.items():
        np.testing.assert_allclose(tleaves[k].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


# (voltage, ecc, method): clean, deep bitwise write-path injection, ECC
GEN_CASES = [(None, False, "auto"), (0.86, False, "bitwise"),
             (0.875, True, "auto")]


@pytest.mark.parametrize("v,ecc,method", GEN_CASES)
def test_generate_matches_jax(v, ecc, method):
    jp, tp = _params()
    jplan, tplan = (None, None) if v is None else _plans(v, ecc)
    want = np.asarray(jserve.generate(
        JB, JCFG, jp, {"tokens": jnp.asarray(TOKENS)},
        jserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                           undervolt=jplan, kv_method=method)))
    got = {}
    for mode in ("auto", "write", "rewrite"):
        got[mode] = tserve.generate(
            TB, TCFG, tp, {"tokens": TOKENS},
            tserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                               undervolt=tplan, kv_injection=mode,
                               kv_method=method), device="cpu").numpy()
    np.testing.assert_array_equal(got["write"], want)
    np.testing.assert_array_equal(got["auto"], got["write"])
    np.testing.assert_array_equal(got["rewrite"], got["write"])


def _random_cache(avals, seed):
    """Random float leaves (a fresh cache's ints stay zero), as numpy."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, a in avals.items():
        if np.dtype(a.dtype).kind == "f":
            out[k] = rng.standard_normal(a.shape).astype(a.dtype)
        else:
            out[k] = np.zeros(a.shape, a.dtype)
    return out


def _unflatten(template, flat):
    tree = jax.tree_util.tree_map(lambda x: x, template)
    paths = jax.tree_util.tree_flatten_with_path(template)[0]
    leaves = [flat[jax.tree_util.keystr(p)] for p, _ in paths]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                        leaves)


def test_persistent_fault_oracle_matches_jax():
    """The step's write-path injection corrupts carried ``state`` leaves
    WHOLE, equal to the one-shot whole-tree oracle and idempotent, ring
    leaves only at the written row, at 0.84 V.  The word-method step is
    held against the reference on raw uint32 bits (the reference traces
    the bitwise masks of every leaf for seconds; the port's bitwise
    masks equal the reference's in tests/test_torch_injection.py), and
    both methods against the oracle."""
    jspecs = JB.module.cache_specs(JCFG, 1, MAX_LEN)
    tspecs = TB.module.cache_specs(TCFG, 1, MAX_LEN)
    javals = jbase.spec_avals(jspecs)
    jplan, tplan = _plans(0.84, False)
    jplc = jplan.place({"kv_cache": javals})["kv_cache"]
    tplc = tplan.place({"kv_cache": base.spec_avals(tspecs)})["kv_cache"]
    flat = _random_cache(_jleaves(javals), 5)
    jtree = _unflatten(javals, {k: jnp.asarray(x) for k, x in flat.items()})
    v = 0.84
    jstep, _ = jax.jit(lambda t: jengine.inject_placement_slice(
        t, jplc, jplan.fault_map(), slot_axes=jbase.cache_slot_axes(
            jspecs), pos=jnp.int32(3), voltage=jnp.float32(v),
        method="word"))(jtree)
    jstep = _jleaves(jax.tree.map(np.asarray, jstep))

    def tree():
        return convert.cache_from_jax(_unflatten(javals, flat))

    def bits(t):
        return {k: convert.tensor_to_numpy_bits(x)
                for k, x in _leaves(t).items()}

    slot_axes = base.cache_slot_axes(tspecs)
    axes = _leaves(slot_axes)
    state = set(readpath.state_leaf_paths(tspecs, MAX_LEN))
    fresh = bits(tree())
    for method in ("word", "bitwise"):
        kw = dict(voltage=v, method=method)
        step, _ = engine.inject_placement_slice(
            tree(), tplc, tplan.fault_map(), slot_axes=slot_axes, pos=3, **kw)
        oracle, _ = inject_group(tree(), tplc, tplan.fault_map(), **kw)
        step, oracle = bits(step), bits(oracle)
        again, _ = engine.inject_placement_slice(
            convert.cache_from_jax(_unflatten(javals, {
                k: x.view(flat[k].dtype) for k, x in step.items()})),
            tplc, tplan.fault_map(), slot_axes=slot_axes, pos=4, **kw)
        again = bits(again)
        corrupted_state = 0
        for k, got in step.items():
            if method == "word":
                np.testing.assert_array_equal(
                    got, jstep[k].view(got.dtype), err_msg=k)
            if k in state:
                np.testing.assert_array_equal(got, oracle[k], err_msg=k)
                np.testing.assert_array_equal(again[k], got, err_msg=k)
                corrupted_state += int((got != fresh[k]).any())
            elif axes[k] >= 0:
                other = [i for i in range(got.shape[axes[k]]) if i != 3]
                np.testing.assert_array_equal(
                    np.take(got, other, axis=axes[k]),
                    np.take(fresh[k], other, axis=axes[k]), err_msg=k)
        assert corrupted_state >= 1, method


def test_unserved_paths_raise():
    """The read path stays refused for this family; training, which used
    to raise here, runs since the training slice (its parity with the
    reference is held by tests/test_torch_training.py)."""
    _, tp = _params()
    loss, metrics = TB.module.forward_train(
        tp, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, TCFG)
    assert metrics["loss"] is loss and bool(torch.isfinite(loss))
    _, cache = TB.module.prefill(tp, {"tokens": torch.zeros(
        (1, 4), dtype=torch.int64)}, TCFG, MAX_LEN)
    with pytest.raises(ValueError, match="no read path"):
        TB.module.decode_step(tp, cache, {"tokens": torch.zeros(
            (1, 1), dtype=torch.int64)}, 4, TCFG, fault_ctx=object())
    with pytest.raises(ValueError, match="read-path support"):
        tserve.generate(TB, TCFG, tp, {"tokens": TOKENS},
                        tserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=2,
                                           undervolt=_plans(0.88, False)[1],
                                           kv_injection="read"),
                        device="cpu")
