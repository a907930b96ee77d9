"""The dense zoo configs the port adds -- gemma3-4b (5 sliding-window
layers to 1 global), llama3-8b and yi-34b (GQA group 7) -- held against
the reference on their reduced shapes in float32, and gemma3's window
rings through the paged scheduler's chunked prefill.

Weights are made with numpy from a seed and handed to both packages.
Prefill and decode logits agree within 1e-5 of the largest magnitude;
greedy tokens are equal.  Under the paged scheduler (chunk 4 < window 8,
prompts longer than the window) every request equals its solo
``generate(kv_placement=)`` replay on bits, and the longest the
reference's ``generate()`` tokens.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import base as jbase
from repro.serving import engine as jserve

from repro_torch import convert
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.hbm import VCU128
from repro_torch.models import base
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.training.undervolt import UndervoltPlan

ZOO = ("gemma3-4b", "llama3-8b", "yi-34b")
RTOL = 1e-5
MAX_LEN = 32
# The field of the reference's ArchConfig the port has no use for (the
# launcher's default sequence length).
NOT_PORTED_FIELDS = set()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(JAX bundle, cfg, params, torch bundle, cfg, params), float32,
    one numpy init."""
    jb, tb = jbase.get_arch(name), base.get_arch(name)
    jcfg = dataclasses.replace(jb.reduced, dtype=jnp.float32)
    tcfg = dataclasses.replace(tb.reduced, dtype=torch.float32)
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
    return (jb, jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tb, tcfg,
            convert.params_from_jax(tree))


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= RTOL, (what, err)


@pytest.mark.parametrize("name", ZOO + ("deepseek-v2-lite-16b",
                                        "deepseek-v2-236b"))
def test_configs_equal_reference(name):
    """CFG and REDUCED field for field (dtypes by name)."""
    jb, tb = jbase.get_arch(name), base.get_arch(name)
    port_fields = {f.name for f in dataclasses.fields(tb.cfg)}
    ref_fields = {f.name for f in dataclasses.fields(jb.cfg)}
    assert ref_fields - port_fields == NOT_PORTED_FIELDS
    assert port_fields <= ref_fields
    assert tb.module.__name__ == "repro_torch.models." + \
        jb.module.__name__.rsplit(".", 1)[1]
    for want, got in ((jb.cfg, tb.cfg), (jb.reduced, tb.reduced)):
        for f in sorted(port_fields):
            a, b = getattr(want, f), getattr(got, f)
            if f == "dtype":
                assert str(b).rsplit(".", 1)[-1] == jnp.dtype(a).name, name
            else:
                assert a == b, (name, f, a, b)


@pytest.mark.parametrize("name", ZOO)
def test_prefill_decode_logits_and_tokens_match_reference(name):
    """Prefill logits (a prompt past gemma3's window), three decode steps'
    logits, and greedy generate() tokens equal to the reference's greedy
    decode (the argmax of each of those logits)."""
    jb, jcfg, jp, tb, tcfg, tp = _setup(name)
    toks = np.random.RandomState(1).randint(0, jcfg.vocab, (2, 11))
    jl, jc = jax.jit(lambda p, t: jb.module.prefill(
        p, {"tokens": t}, jcfg, MAX_LEN))(jp, jnp.asarray(toks))
    tl, tc = tb.module.prefill(tp, {"tokens": torch.from_numpy(toks)},
                               tcfg, MAX_LEN)
    _close(tl.numpy(), jl, f"{name} prefill")
    jstep = jax.jit(lambda p, c, t, pos: jb.module.decode_step(
        p, c, {"tokens": t}, pos, jcfg))
    nxt = np.asarray(jnp.argmax(jl, -1))[:, None]
    want = [nxt]
    for i in range(3):
        pos = toks.shape[1] + i
        jl, jc = jstep(jp, jc, jnp.asarray(nxt), jnp.int32(pos))
        tl, tc = tb.module.decode_step(
            tp, tc, {"tokens": torch.from_numpy(nxt.copy())}, pos, tcfg)
        _close(tl.numpy(), jl, f"{name} decode {i}")
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None]
        want.append(nxt)
    got = generate(tb, tcfg, tp, {"tokens": torch.from_numpy(toks)},
                   ServeConfig(max_len=MAX_LEN, max_new_tokens=4),
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, 1))


# (rid, prompt length, new tokens): two prompts past the window of 8,
# overlapping lifetimes through two slots
GEMMA_REQS = ((13, 5), (5, 6), (19, 4))


def _plan(v):
    return UndervoltPlan(
        domains={"kv": MemoryDomain("kv", v, (8, 15, 18, 29), ecc=False)},
        policy={"kv_cache": "kv"}, geometry=VCU128)


@pytest.mark.parametrize("v,mode", [(None, "auto"), (0.885, "read"),
                                    (0.885, "write")],
                         ids=["clean", "read", "write"])
def test_gemma3_window_chunked_prefill_equals_replay(v, mode):
    """gemma3 under the paged scheduler, chunk 4 < window 8: the local
    layers' chunked prefill attends over a pre-chunk ring snapshot plus
    the chunk (a chunk's own writes evict positions its earlier queries
    still attend), and every request equals its solo replay on bits --
    clean (K4 without injection == generate() at the page tile) and with
    read- and write-path faults; clean, the longest request's tokens
    equal the reference's generate()."""
    jb, jcfg, jp, tb, tcfg, tp = _setup("gemma3-4b")
    rng = np.random.RandomState(2)
    reqs = [(f"r{i}", rng.randint(0, tcfg.vocab, (n,)), m)
            for i, (n, m) in enumerate(GEMMA_REQS)]
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=4, prefill_chunk=4,
                     undervolt=None if v is None else _plan(v),
                     kv_injection=mode,
                     kv_method="auto" if v is None else "word")
    sched = ContinuousBatchingScheduler(tb, tcfg, tp, sc, num_slots=2,
                                        num_pages=24, page_slots=4,
                                        device="cpu")
    assert set(sched.stats["cache_layouts"]) == {"full", "window"}
    for rid, toks, n in reqs:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
    res = sched.run()
    assert sched.stats["decode_traces"] == 1
    for rid, toks, n in reqs:
        ref = generate(tb, tcfg, tp, {"tokens": toks[None]},
                       dataclasses.replace(
                           sc, max_new_tokens=n,
                           kv_tile=4 if v is None else None),
                       device="cpu", kv_placement=res[rid].placement)
        np.testing.assert_array_equal(res[rid].tokens, ref.numpy(), rid)
        if v is None and rid == reqs[-1][0]:
            want = jserve.generate(
                jb, jcfg, jp, {"tokens": jnp.asarray(toks[None])},
                jserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=n),
                key=jax.random.PRNGKey(0))
            np.testing.assert_array_equal(res[rid].tokens, np.asarray(want),
                                          rid)
    if v is not None:
        clean = {rid: generate(tb, tcfg, tp, {"tokens": toks[None]},
                               ServeConfig(max_len=MAX_LEN,
                                           max_new_tokens=n),
                               device="cpu").numpy()
                 for rid, toks, n in reqs}
        assert any(not np.array_equal(res[rid].tokens, clean[rid])
                   for rid in clean), "no fault reached a token"


def test_gemma3_window_as_long_as_max_len_equals_replay():
    """max_len == window (8): every ring is max_len long, so a chunk's
    write evicts nothing and the window lanes gather their band from the
    written ring; requests still equal their solo replays on bits."""
    _, _, _, tb, tcfg, tp = _setup("gemma3-4b")
    rng = np.random.RandomState(4)
    reqs = [("a", rng.randint(0, tcfg.vocab, (6,)), 2),
            ("b", rng.randint(0, tcfg.vocab, (3,)), 4)]
    sc = ServeConfig(max_len=tcfg.window, max_new_tokens=2, prefill_chunk=4,
                     undervolt=_plan(0.885), kv_injection="write",
                     kv_method="word")
    sched = ContinuousBatchingScheduler(tb, tcfg, tp, sc, num_slots=2,
                                        num_pages=8, page_slots=4,
                                        device="cpu")
    assert set(sched.stats["cache_layouts"]) == {"full"}
    for rid, toks, n in reqs:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n))
    res = sched.run()
    for rid, toks, n in reqs:
        ref = generate(tb, tcfg, tp, {"tokens": toks[None]},
                       dataclasses.replace(sc, max_new_tokens=n),
                       device="cpu", kv_placement=res[rid].placement)
        np.testing.assert_array_equal(res[rid].tokens, ref.numpy(), rid)
