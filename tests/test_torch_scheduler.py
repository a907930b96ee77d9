"""The port's continuous-batching scheduler: the acceptance contract.

Overlapping mixed-tier requests served through the paged KV pool give,
token for token, what each request gives alone through ``generate()`` on
its own pages (``kv_placement=results[rid].placement``) -- greedy and
sampled, read and write injection, ECC on and off, with and without a
shared prompt prefix -- while the paged kernel K4 runs once per layer and
step whatever the pool size, slot count and mode.  A clean pool equals
clean ``generate()`` at the page tile.  One greedy run is held against
the reference's scheduler on converted weights.  Capacity exhaustion is
backpressure; unsupported options fail loudly, naming their slice, and
misconfigured healing or governors raise the reference's ValueErrors.
"""
import dataclasses
import functools
import types

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
from repro.serving import scheduler as jsched
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core.domains import CapacityError, MemoryDomain
from repro_torch.core.hbm import VCU128
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import faulty
from repro_torch.models.base import ArchBundle, get_arch, init_params
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request, SelfHealConfig)
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


TB = get_arch("llama3.2-3b")
CFG = TB.reduced                          # bf16, 2 layers
PS = 8
_R = np.random.RandomState(7)
# (rid, prompt, max_new_tokens, tier, generator seed): overlapping
# requests with distinct prompt lengths, lifetimes and tiers
REQS = [
    ("a", _R.randint(0, CFG.vocab, (5,)), 4, "cheap", 11),
    ("b", _R.randint(0, CFG.vocab, (9,)), 6, "critical", 22),
    ("c", _R.randint(0, CFG.vocab, (12,)), 8, "cheap", 33),
]
# a 16-token prefix shared by three prompts; "r" repeats "p" whole, so its
# admission forks p's partly filled boundary page copy-on-write
_BASE = _R.randint(0, CFG.vocab, (16,))
_P = np.concatenate([_BASE, _R.randint(0, CFG.vocab, (3,))])
SHARED = [("p", _P, 5, "cheap", 1),
          ("q", np.concatenate([_BASE, _R.randint(0, CFG.vocab, (5,))]), 5,
           "critical", 2),
          ("r", _P.copy(), 4, "cheap", 3)]


@functools.lru_cache(maxsize=None)
def _params():
    return init_params(TB.module.param_specs(CFG),
                       torch.Generator().manual_seed(0), device="cpu")


def _plan(v, ecc=False):
    return UndervoltPlan(
        domains={"kv": MemoryDomain("kv", v, tuple(range(32)), ecc=ecc)},
        policy={"kv_cache": "kv"}, geometry=VCU128)


def _sc(mode, temperature=0.0, plan=None, method="bitwise", **kw):
    return ServeConfig(max_len=32, max_new_tokens=4, temperature=temperature,
                       undervolt=plan, kv_injection=mode, kv_method=method,
                       **kw)


def _serve(sc, reqs=REQS, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("num_pages", 16)
    kw.setdefault("page_slots", PS)
    sched = ContinuousBatchingScheduler(TB, CFG, _params(), sc, device="cpu",
                                        **kw)
    for rid, toks, n, tier, seed in reqs:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                             tier=tier,
                             generator=torch.Generator().manual_seed(seed)))
    return sched, sched.run()


def _replay(sc, res, reqs=REQS, clean=False):
    """Each request alone through generate() on its own pages (a clean
    pool: through K3 without injection at the page tile)."""
    out = {}
    for rid, toks, n, tier, seed in reqs:
        out[rid] = generate(
            TB, CFG, _params(), {"tokens": toks[None]},
            dataclasses.replace(sc, max_new_tokens=n,
                                kv_tile=PS if clean else None),
            device="cpu", generator=torch.Generator().manual_seed(seed),
            kv_placement=None if clean else res[rid].placement).numpy()
    return out


def _assert_replays(sc, res, reqs=REQS, clean=False):
    refs = _replay(sc, res, reqs, clean)
    for rid, *_ in reqs:
        np.testing.assert_array_equal(refs[rid], res[rid].tokens,
                                      err_msg=str(rid))


@pytest.mark.parametrize("mode,temperature,ecc", [
    ("read", 0.0, False), ("read", 0.7, False), ("write", 0.0, False),
    ("read", 0.0, True), ("write", 0.7, True)])
def test_scheduler_matches_solo_replay(mode, temperature, ecc):
    """Overlapped mixed-tier serving deep in the collapse regime == each
    request alone on its own pages, bit for bit; faults really change
    the tokens."""
    plan = _plan(0.86, ecc)
    sc = _sc(mode, temperature, plan, "word" if ecc else "bitwise")
    sched, res = _serve(sc)
    assert sched.peak_active == 3, sched.stats
    _assert_replays(sc, res)
    _, clean = _serve(_sc(mode, temperature, None))
    assert any((clean[rid].tokens != res[rid].tokens).any()
               for rid, *_ in REQS)


def test_scheduler_matches_solo_replay_word_regime():
    """Sparse faults (word path): the equality holds on live numerics."""
    sc = _sc("read", 0.0, _plan(0.88), "word")
    _, res = _serve(sc)
    _assert_replays(sc, res)


@pytest.mark.parametrize("mode,ecc", [("read", False), ("write", True)])
def test_shared_prefix_pages_and_cow_fork_match_replay(mode, ecc):
    sc = _sc(mode, 0.0, _plan(0.86, ecc), "word" if ecc else "bitwise",
             share_prefix=True)
    sched, res = _serve(sc, SHARED, num_slots=1, num_pages=12)
    assert res["q"].pages_shared == 2 and res["r"].pages_shared == 2
    assert sched.stats["events"]["cow_fork"] == 1
    assert sched.stats["shared_pages"] > 0
    _assert_replays(sc, res, SHARED)


def test_read_equals_write_and_clean_pool_equals_clean_generate():
    _, read = _serve(_sc("read", 0.0, _plan(0.87, True), "word"))
    _, write = _serve(_sc("write", 0.0, _plan(0.87, True), "word"))
    for rid, *_ in REQS:
        np.testing.assert_array_equal(read[rid].tokens, write[rid].tokens)
    sc = _sc("auto", 0.0, None)
    _, res = _serve(sc)
    assert all(res[rid].placement is None for rid, *_ in REQS)
    _assert_replays(sc, res, clean=True)


def test_churn_backpressure_recycling_and_metrics():
    """Six requests through two slots and eight pages: admission waits
    for capacity, retired pages are recycled, every request matches its
    replay, and the in-step counters and event trace add up."""
    reqs = [(i, _R.randint(0, CFG.vocab, (4 + i,)), 3 + (i % 3),
             "cheap" if i % 2 else "hedged", 7 * i + 1) for i in range(6)]
    sc = _sc("write", 0.0, _plan(0.86))
    sched, res = _serve(sc, reqs=reqs, num_slots=2, num_pages=8)
    assert len(res) == 6 and sched.peak_active == 2 and sched.admitted == 6
    assert sched.pool.free_pages == 8
    _assert_replays(sc, res, reqs)
    st = sched.stats
    totals = st["obs"]["totals"]
    assert totals["tokens_decoded"] == sum(res[r].tokens.shape[1] - 1
                                           for r in res)
    assert totals["prefill_tokens"] == sum(len(t) for _, t, *_ in reqs)
    assert st["events"]["admission"] == st["events"]["retirement"] == 6
    assert st["events"]["backpressure"] >= 1
    assert st["obs"]["energy"]["joules_per_token"] > 0


def test_k4_launch_budget_flat(monkeypatch):
    """One paged-attention call per layer and step -- whatever the pool
    size, slot count, admissions and injection mode (the write path is
    plain PyTorch)."""
    calls = []
    real = faulty.paged_decode_attention
    monkeypatch.setattr(faulty, "paged_decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for mode in ("read", "write"):
        for num_pages, num_slots in ((8, 2), (24, 6)):
            calls.clear()
            sched, _ = _serve(_sc(mode, 0.0, _plan(0.88), "word"),
                              num_slots=num_slots, num_pages=num_pages)
            assert len(calls) == CFG.n_layers * sched.steps, (mode,
                                                             num_pages)


# ---------------------------------------------------------------------------
# against the reference's scheduler
# ---------------------------------------------------------------------------

JB = jget_arch("llama3.2-3b")
F32 = dict(dtype=jnp.float32)


def test_greedy_tokens_match_reference_scheduler():
    """Greedy tokens of the port's scheduler equal the reference's on
    converted float32 weights (word regime, read mode)."""
    jcfg = dataclasses.replace(JB.reduced, **F32)
    tcfg = dataclasses.replace(CFG, dtype=torch.float32)
    jp = jinit_params(JB.module.param_specs(jcfg), jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    pcs = tuple(range(32))
    jplan = JPlan(domains={"kv": JDomain("kv", 0.88, pcs)},
                  policy={"kv_cache": "kv"}, geometry=JVCU128)
    kw = dict(max_len=32, max_new_tokens=4, kv_injection="read",
              kv_method="word")
    js = jsched.ContinuousBatchingScheduler(
        JB, jcfg, jp, jserve.ServeConfig(undervolt=jplan, **kw),
        num_slots=4, num_pages=16, page_slots=PS)
    ts = ContinuousBatchingScheduler(
        TB, tcfg, tp, ServeConfig(undervolt=_plan(0.88), **kw),
        num_slots=4, num_pages=16, page_slots=PS, device="cpu")
    for rid, toks, n, tier, _ in REQS:
        js.submit(jsched.Request(rid=rid, tokens=toks, max_new_tokens=n,
                                 tier=tier))
        ts.submit(Request(rid=rid, tokens=toks, max_new_tokens=n, tier=tier))
    jres, tres = js.run(), ts.run()
    for rid, *_ in REQS:
        np.testing.assert_array_equal(tres[rid].tokens, jres[rid].tokens,
                                      err_msg=rid)
        np.testing.assert_array_equal(tres[rid].page_ids, jres[rid].page_ids)


# ---------------------------------------------------------------------------
# typed errors
# ---------------------------------------------------------------------------


def test_capacity_and_submit_errors_are_typed():
    sc = _sc("read", 0.0, _plan(0.88), "word")
    sched = ContinuousBatchingScheduler(TB, CFG, _params(), sc, num_slots=2,
                                        num_pages=2, page_slots=PS,
                                        device="cpu")
    sched.submit(Request("x", REQS[0][1], 2, "cheap"))
    with pytest.raises(CapacityError):
        sched.run()                   # needs 4 pages, the pool has 2
    sched = ContinuousBatchingScheduler(TB, CFG, _params(), sc, num_slots=2,
                                        num_pages=8, page_slots=PS,
                                        device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(Request("z", REQS[0][1], 0, "cheap"))
    with pytest.raises(ValueError, match="empty prompt"):
        sched.submit(Request("e", np.zeros((0,), np.int32), 2))
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.submit(Request("o", np.zeros((33,), np.int32), 2))
    assert not sched.queue and sched.pool.free_pages == 8


def test_rewrite_and_unported_options_raise():
    plan = _plan(0.88)
    kw = dict(num_slots=2, num_pages=8, page_slots=PS, device="cpu")
    with pytest.raises(ValueError, match="rewrite"):
        ContinuousBatchingScheduler(TB, CFG, _params(),
                                    _sc("rewrite", 0.0, plan), **kw)
    sc = _sc("read", 0.0, plan, "word")
    _, res = _serve(sc, reqs=REQS[:1], num_slots=1, num_pages=4)
    with pytest.raises(ValueError, match="rewrite"):
        generate(TB, CFG, _params(), {"tokens": REQS[0][1][None]},
                 dataclasses.replace(sc, kv_injection="rewrite"),
                 device="cpu", kv_placement=res["a"].placement)
    for extra in (dict(mesh=object()), dict(shard_seeds=(1, 2))):
        with pytest.raises(NotImplementedError, match="slice 13"):
            ContinuousBatchingScheduler(TB, CFG, _params(), sc, **kw,
                                        **extra)
    # self-healing and the per-admission governor are ported: their
    # misconfigurations raise the reference's ValueErrors
    with pytest.raises(ValueError, match="ECC"):
        ContinuousBatchingScheduler(TB, CFG, _params(), sc, **kw,
                                    self_heal=SelfHealConfig())
    with pytest.raises(ValueError, match="built from sc.undervolt"):
        ContinuousBatchingScheduler(
            TB, CFG, _params(), dataclasses.replace(
                sc, governor=_plan(0.88).make_governor("kv")), **kw)
    # a family without a pageable cache goes to the state-arena route,
    # where expert tiering refuses a family without routing_frequency
    # with the reference's ValueError, and share_prefix (prefill reuse)
    # builds
    unpaged = ArchBundle(cfg=CFG, module=types.SimpleNamespace(
        cache_specs=TB.module.cache_specs), reduced=CFG)
    sc_w = dataclasses.replace(sc, kv_injection="write")
    with pytest.raises(ValueError, match="MoE-only"):
        ContinuousBatchingScheduler(unpaged, CFG, _params(), sc_w, **kw,
                                    expert_probe=np.arange(4))
    shared = ContinuousBatchingScheduler(
        unpaged, CFG, _params(), dataclasses.replace(sc_w, share_prefix=True),
        **kw)
    assert isinstance(shared, StateArenaScheduler)
    assert shared.prefill_reuse == 0 and shared.sc.share_prefix


@pytest.mark.cuda
def test_scheduler_on_card_launch_budget_and_replay(cuda_device):
    params = init_params(TB.module.param_specs(CFG),
                         torch.Generator(device=cuda_device).manual_seed(0),
                         device=cuda_device)
    sc = _sc("read", 0.0, _plan(0.86, True), "word")
    sched = ContinuousBatchingScheduler(TB, CFG, params, sc, num_slots=4,
                                        num_pages=16, page_slots=PS,
                                        device=cuda_device)
    for rid, toks, n, tier, _ in REQS:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                             tier=tier))
    _build.reset_launch_counts()
    res = sched.run()
    assert _build.launch_counts()["paged_decode"] == (CFG.n_layers
                                                      * sched.steps)
    for rid, toks, n, *_ in REQS:
        ref = generate(TB, CFG, params, {"tokens": toks[None]},
                       dataclasses.replace(sc, max_new_tokens=n),
                       device=cuda_device, kv_placement=res[rid].placement)
        np.testing.assert_array_equal(ref.cpu().numpy(), res[rid].tokens)
