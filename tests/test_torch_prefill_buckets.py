"""Padded, power-of-two-bucketed prefill: one body per (batch size,
bucket), captured once on the card, with logits and the whole cache equal
on bits to the unpadded prefill.

On the CPU, on reduced llama3.2-3b in float32 with weights made with
numpy from a seed and handed to both packages: ``_next_pow2`` equals the
reference's; the padded prefill equals the port's exact prefill on bits
at every length and batch size, and the reference's ``_BucketedPrefill``
within 1e-5 (positions exactly), with as many bodies built as the
reference traces; the body reads nothing on the host (what a CUDA graph
cannot hold); window rings and the hybrid, MoE and xLSTM families take
the exact route; ``generate()`` and the state-arena scheduler share the
process-wide instance, greedy tokens through buckets equal the
reference's, and a ``share_prefix`` hit is unchanged by later admissions
in its bucket.  On the card (``cuda``-marked): the captured buckets equal
the eager exact prefill on bits, and a returned cache is unchanged by the
next replay of its bucket.
"""
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.domains import MemoryDomain as JDomain
from repro.core.hbm import VCU128 as JVCU128
from repro.models import base as jbase
from repro.serving import engine as jserve
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core import pytree
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.hbm import VCU128
from repro_torch.models import base
from repro_torch.serving import engine as tserve
from repro_torch.serving.scheduler import Request
from repro_torch.serving.statearena import StateArenaScheduler
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


JB, TB = jbase.get_arch("llama3.2-3b"), base.get_arch("llama3.2-3b")
JCFG = dataclasses.replace(JB.reduced, dtype=jnp.float32)
TCFG = dataclasses.replace(TB.reduced, dtype=torch.float32)
MAX_LEN = 32
LENGTHS = (1, 5, 8, 9, 12, 16, 31, 32)
BATCHES = (1, 3)
TOKENS = {b: np.random.RandomState(3 + b).randint(0, JCFG.vocab, (b, 32))
          for b in BATCHES}
TOL = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _params():
    """Weights made with numpy from a seed (the reference's init rules),
    handed to both packages."""
    rng = np.random.RandomState(0)

    def mk(s):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.standard_normal(s.shape) * (s.scale / np.sqrt(fan_in))
                ).astype(np.float32)

    tree = jax.tree_util.tree_map(
        mk, JB.module.param_specs(JCFG),
        is_leaf=lambda x: isinstance(x, jbase.ParamSpec))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.params_from_jax(tree))


def _bits_equal(a, b):
    la, lb = pytree.leaves(a), pytree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and torch.equal(x, y)


@pytest.fixture(scope="module")
def jax_buckets():
    """The reference's _BucketedPrefill over every (batch, length) case,
    once: (logits, cache leaves) per case, and its traces per batch."""
    jp = _params()[0]
    out = {}
    for b in BATCHES:
        bp = jserve._BucketedPrefill(JB.module, JCFG, MAX_LEN)
        for s in LENGTHS:
            lg, cache = bp(jp, {"tokens": jnp.asarray(TOKENS[b][:, :s],
                                                      jnp.int32)})
            out[(b, s)] = (np.asarray(lg), [
                np.asarray(x) for x in jax.tree_util.tree_leaves(cache)])
        out[b] = len(bp.traces)
    return out


def test_next_pow2_equals_reference():
    assert [tserve._next_pow2(n) for n in range(1, 2050)] == [
        jserve._next_pow2(n) for n in range(1, 2050)]


@pytest.mark.parametrize("b", BATCHES)
def test_padded_prefill_equals_exact_on_bits(b, jax_buckets):
    """Logits and every cache leaf, pos included, at every length; one
    body per bucket hit, as many as the reference traces."""
    params = _params()[1]
    bp = tserve._BucketedPrefill(TB.module, TCFG, MAX_LEN)
    assert bp.uniform
    for s in LENGTHS:
        toks = torch.from_numpy(TOKENS[b][:, :s])
        got = bp(params, {"tokens": toks})
        want = TB.module.prefill(params, {"tokens": toks}, TCFG, MAX_LEN)
        assert torch.equal(got[0], want[0]), s
        _bits_equal(got[1], want[1])
    assert bp.traces == len({min(tserve._next_pow2(s), MAX_LEN)
                             for s in LENGTHS}) == jax_buckets[b]


@pytest.mark.parametrize("b", BATCHES)
def test_padded_prefill_equals_reference(b, jax_buckets):
    params = _params()[1]
    bp = tserve._BucketedPrefill(TB.module, TCFG, MAX_LEN)
    for s in LENGTHS:
        lg, cache = bp(params, {"tokens": torch.from_numpy(TOKENS[b][:, :s])})
        jlg, jleaves = jax_buckets[(b, s)]
        np.testing.assert_allclose(lg.numpy(), jlg, **TOL)
        paths = [pytree.keystr(p) for p, _ in pytree.flatten_with_path(cache)]
        for path, got, want in zip(paths, pytree.leaves(cache), jleaves):
            if path.endswith("['pos']"):
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                np.testing.assert_allclose(got.numpy(), want, **TOL,
                                           err_msg=path)


class _NoHostRead(TorchDispatchMode):
    """Raises on what a CUDA graph cannot hold: a scalar read, a
    boolean-mask index, a tensor made from host data."""

    READS = {torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default,
             torch.ops.aten.lift_fresh.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError(f"the prefill body calls {func}")
        if func in (torch.ops.aten.index.Tensor,
                    torch.ops.aten.index_put_.default) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            raise AssertionError(f"the prefill body masks with {func}")
        return func(*args, **(kwargs or {}))


def test_bucket_body_reads_nothing_on_the_host(monkeypatch):
    """The body a bucket captures, run on the CPU under a mode that fails
    on host reads, gives the unguarded call's bits."""
    params = _params()[1]
    bp = tserve._BucketedPrefill(TB.module, TCFG, MAX_LEN)
    toks = torch.from_numpy(TOKENS[3][:, :11])
    want = bp(params, {"tokens": toks})
    step = bp._steps[(toks.device, 3, 16)]
    body = step.body

    def guarded():
        with _NoHostRead():
            return body()

    monkeypatch.setattr(step, "body", guarded)
    got = bp(params, {"tokens": toks})
    assert torch.equal(got[0], want[0])
    _bits_equal(got[1], want[1])
    assert bp.traces == 1


def test_bodies_follow_the_parameter_tensors():
    """The bodies read the parameters they were built on: a call with
    other parameter tensors builds anew (and gets their prefill), and
    freeing the bound parameters drops every body."""
    bp = tserve._BucketedPrefill(TB.module, TCFG, MAX_LEN)
    toks = torch.from_numpy(TOKENS[1][:, :7])
    pa, pb = (pytree.tree_map(torch.clone, _params()[1]) for _ in range(2))
    pb["ln_f"].add_(0.5)
    for params, traces in ((pa, 1), (pb, 2), (pa, 3), (pa, 3)):
        got = bp(params, {"tokens": toks})
        want = TB.module.prefill(params, {"tokens": toks}, TCFG, MAX_LEN)
        assert torch.equal(got[0], want[0]) and bp.traces == traces
    del pb                                  # not bound: nothing dropped
    gc.collect()
    assert len(bp._steps) == 1
    del pa, params
    gc.collect()                            # (pytree's walks hold cycles)
    assert not bp._steps and not bp._outputs


def _exact_route_cases():
    return {
        "window": (TB, dataclasses.replace(TCFG, pattern=("local", "global"),
                                           window=8),
                   JB, dataclasses.replace(JCFG, pattern=("local", "global"),
                                           window=8)),
        **{k: (base.get_arch(a), base.get_arch(a).reduced,
               jbase.get_arch(a), jbase.get_arch(a).reduced)
           for k, a in (("hybrid", "recurrentgemma-9b"),
                        ("moe", "deepseek-v2-lite-16b"),
                        ("xlstm", "xlstm-350m"))}}


@pytest.mark.parametrize("family", ["window", "hybrid", "moe", "xlstm"])
def test_exact_route_families(family):
    """Window rings (uniform false) and families without the flag (no
    instance) take the exact prefill and build no body, as in the
    reference."""
    tb, tcfg, jb, jcfg = _exact_route_cases()[family]
    bp = tserve.bucketed_prefill(tb.module, tcfg, MAX_LEN)
    jbp = jserve.bucketed_prefill(jb.module, jcfg, MAX_LEN)
    assert (bp is None) == (jbp is None)
    if bp is None:
        return
    assert not bp.uniform and not jbp.uniform
    params = base.init_params(tb.module.param_specs(tcfg),
                              torch.Generator().manual_seed(1), device="cpu")
    toks = torch.from_numpy(TOKENS[1][:, :12])
    got = bp(params, {"tokens": toks})
    want = tb.module.prefill(params, {"tokens": toks}, tcfg, MAX_LEN)
    assert torch.equal(got[0], want[0])
    _bits_equal(got[1], want[1])
    assert bp.traces == 0


class _Wrapper:
    """A module that forwards to the dense module (as one that records
    its decode steps does)."""

    def __getattr__(self, name):
        return getattr(TB.module, name)


def test_generate_shares_the_process_wide_instance():
    """Four prompt lengths in two buckets build at most two bodies, and a
    fresh length in a warm bucket none; a wrapper module shares the
    module's instance and is not kept alive by it."""
    bp = tserve.bucketed_prefill(TB.module, TCFG, 48)
    before = bp.traces
    sc = tserve.ServeConfig(max_len=48, max_new_tokens=2)
    rng = np.random.RandomState(11)
    wrapper = _Wrapper()
    alive = weakref.ref(wrapper)
    for bundle, s in ((dataclasses.replace(TB, module=wrapper), 5),
                      (TB, 6), (TB, 7), (TB, 9)):   # buckets 8, 8, 8, 16
        tserve.generate(bundle, TCFG, _params()[1],
                        {"tokens": rng.randint(0, TCFG.vocab, (1, s))}, sc,
                        device="cpu")
    del wrapper, bundle
    gc.collect()
    assert alive() is None
    assert bp.traces - before <= 2
    warm = bp.traces
    tserve.generate(TB, TCFG, _params()[1],
                    {"tokens": rng.randint(0, TCFG.vocab, (1, 10))}, sc,
                    device="cpu")
    assert bp.traces == warm


PROMPT = np.random.RandomState(0).randint(0, JCFG.vocab, (2, 12))
V_FAULT = 0.88


def _plans(v):
    pcs = tuple(range(32))
    return (JPlan(domains={"kv": JDomain("kv", v, pcs)},
                  policy={"kv_cache": "kv"}, geometry=JVCU128),
            UndervoltPlan(domains={"kv": MemoryDomain("kv", v, pcs)},
                          policy={"kv_cache": "kv"}, geometry=VCU128))


@pytest.fixture(scope="module")
def jax_tokens():
    """The reference's greedy tokens at 0.88 V (read mode; its own tests
    hold read == write), through its bucketed prefill (12 -> 16)."""
    return np.asarray(jserve.generate(
        JB, JCFG, _params()[0], {"tokens": jnp.asarray(PROMPT, jnp.int32)},
        jserve.ServeConfig(max_len=40, max_new_tokens=6,
                           undervolt=_plans(V_FAULT)[0])))


@pytest.mark.parametrize("mode", ["read", "write"])
def test_greedy_tokens_through_buckets_equal_reference(mode, jax_tokens):
    bp = tserve.bucketed_prefill(TB.module, TCFG, 40)
    before = bp.traces
    got = tserve.generate(
        TB, TCFG, _params()[1], {"tokens": PROMPT},
        tserve.ServeConfig(max_len=40, max_new_tokens=6,
                           undervolt=_plans(V_FAULT)[1], kv_injection=mode),
        device="cpu")
    np.testing.assert_array_equal(got.numpy(), jax_tokens)
    assert bp.traces - before <= 1          # (2, 16), once for both modes


def _arena_reqs():
    rng = np.random.RandomState(5)
    a = rng.randint(0, TCFG.vocab, (5,))
    return [("a", a, 3), ("b", rng.randint(0, TCFG.vocab, (7,)), 4),
            ("a2", a.copy(), 3), ("c", rng.randint(0, TCFG.vocab, (6,)), 2)]


def _arena_check(device, params, capture=True):
    """Four admissions (prompts 5, 7, 5 again, 6: all in bucket 8) through
    two slots with share_prefix: the admissions go through the shared
    instance (at most one new body), the hit's cached prefill equals a
    fresh exact prefill after the later admissions replayed its bucket,
    and each request equals its solo generate() replay."""
    sc = tserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=4,
                            undervolt=_plans(0.86)[1], kv_injection="write",
                            share_prefix=True)
    bp = tserve.bucketed_prefill(TB.module, TCFG, MAX_LEN)
    before = bp.traces
    sched = StateArenaScheduler(TB, TCFG, params, sc, num_slots=2,
                                device=device, capture=capture)
    for rid, toks, n in _arena_reqs():
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
    res = sched.run()
    assert bp.traces - before <= 1 and sched.prefill_reuse == 1
    (logits, cache), = [v for k, v in sched._prefill_cache.items()
                        if k.startswith(b"tokens(5,)")]
    a = torch.from_numpy(_arena_reqs()[0][1])[None].to(device)
    want = TB.module.prefill(params, {"tokens": a}, TCFG, MAX_LEN)
    assert torch.equal(logits, want[0])
    _bits_equal(cache, want[1])
    for rid, toks, n in _arena_reqs():
        ref = tserve.generate(TB, TCFG, params, {"tokens": toks[None]},
                              dataclasses.replace(sc, max_new_tokens=n),
                              device=device,
                              kv_placement=res[rid].placement)
        np.testing.assert_array_equal(res[rid].tokens, ref.cpu().numpy())


def test_state_arena_admissions_share_the_instance():
    _arena_check("cpu", _params()[1])


@pytest.mark.cuda
def test_captured_buckets_equal_eager_exact_on_card(cuda_device):
    """Every length at B = 1 and 3: the captured bucket == the eager exact
    prefill on bits, one body per (batch, bucket), none for a second pass,
    and a returned result is unchanged by the next replay of its bucket."""
    params = pytree.tree_map(lambda t: t.to(cuda_device), _params()[1])
    bp = tserve._BucketedPrefill(TB.module, TCFG, MAX_LEN)
    for rep in range(2):
        for b in BATCHES:
            for s in LENGTHS:
                toks = torch.from_numpy(TOKENS[b][:, :s]).to(cuda_device)
                got = bp(params, {"tokens": toks})
                want = TB.module.prefill(params, {"tokens": toks}, TCFG,
                                         MAX_LEN)
                assert torch.equal(got[0], want[0]), (b, s)
                _bits_equal(got[1], want[1])
        assert bp.traces == 2 * 4, rep
    kept = bp(params, {"tokens": torch.from_numpy(TOKENS[3][:, :9]).to(
        cuda_device)})
    snap = pytree.tree_map(torch.clone, kept)
    bp(params, {"tokens": torch.from_numpy(TOKENS[3][:, 10:22]).to(
        cuda_device)})
    _bits_equal(kept, snap)
    assert bp.pool_bytes > 0
    # other parameter tensors, then the first again: each binding captures
    # anew in a fresh pool
    other = pytree.tree_map(torch.clone, params)
    other["ln_f"].add_(0.5)
    toks = torch.from_numpy(TOKENS[3][:, :9]).to(cuda_device)
    for p in (other, params):
        got = bp(p, {"tokens": toks})
        want = TB.module.prefill(p, {"tokens": toks}, TCFG, MAX_LEN)
        assert torch.equal(got[0], want[0])
        _bits_equal(got[1], want[1])
    assert bp.traces == 2 * 4 + 2


@pytest.mark.cuda
def test_state_arena_admissions_share_the_instance_on_card(cuda_device):
    _arena_check(cuda_device,
                 pytree.tree_map(lambda t: t.to(cuda_device), _params()[1]))
