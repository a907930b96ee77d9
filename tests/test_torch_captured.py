"""The captured decode step (F5): every serving path's decode step is one
CUDA graph on the card, and the same step body runs eagerly on the CPU.

On the CPU: K3's plain version takes its query position as a (B,) tensor
(each row equals the row alone, and the reference at that row's
position); the write path takes a device position and writes the
reference's words at it (word, bitwise, ECC, per row); the step bodies read
nothing on the host (no scalar read, no boolean-mask index, no tensor made
from host data: each would stop or break a capture); an idle slot of the
paged decode step writes nothing to its pages; and each scheduler builds
one step body (``decode_traces == 1``) through admissions and
retirements.  On the card (``cuda``-marked): every serving path captured
equals the eager step on bits (tokens, K/V and state words) with the
same kernel launches, and K3 reads per-row device positions.
"""
import contextlib
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import engine as jengine
from repro.core.domains import MemoryDomain as JDomain
from repro.core.domains import place_groups as jplace
from repro.core.faultmap import FaultMap as JFaultMap
from repro.core.hbm import HBMGeometry as JGeometry
from repro.kernels.flash_attention import faulty as jfaulty

from repro_torch import convert
from repro_torch.core import engine, pytree
from repro_torch.core.domains import MemoryDomain, place_groups
from repro_torch.core.faultmap import FaultMap
from repro_torch.core.hbm import VCU128, HBMGeometry
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import faulty
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models.base import get_arch, init_params
from repro_torch.serving import captured
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request
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


TINY = dict(name="tiny", num_stacks=2, channels_per_stack=2,
            pcs_per_channel=2, bytes_per_pc=64 * 1024)
TGEO, JGEO = HBMGeometry(**TINY), JGeometry(**TINY)
TMAP, JMAP = FaultMap.from_seed(TGEO, 7), JFaultMap.from_seed(JGEO, 7)
B, L, KH, G, D, P = 2, 32, 2, 2, 8, 2
H = KH * G


# ---------------------------------------------------------------------------
# K3's device query position
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _k3_setup(v, ecc):
    """A float32 ring leaf (P, B, L, KH, D) with rows at different decode
    positions, placed in both packages, and its K/V block tables."""
    rng = np.random.RandomState(3)
    tree = {n: rng.randn(P, B, L, KH, D).astype(np.float32)
            for n in ("k", "v")}
    pos = np.repeat(np.arange(L, dtype=np.int32)[None], B, 0)
    pos[1, 20:] = -1                                # row 1: a partial ring
    tree["pos"] = np.repeat(pos[None], P, 0)
    domain = dict(name="d", voltage=v, pc_ids=tuple(range(6)), ecc=ecc)
    jp = jplace({"g": tree}, {"g": "d"}, {"d": JDomain(**domain)}, JGEO)["g"]
    tt = convert.cache_from_jax(tree)
    tp = place_groups({"g": tt}, {"g": "d"}, {"d": MemoryDomain(**domain)},
                      TGEO)["g"]
    paths = [lp.path for lp in tp.leaves]
    ptabs, jtabs = engine.leaf_block_tables(tp), jengine.leaf_block_tables(jp)
    jtab, ttab = {}, {}
    for n in ("k", "v"):
        i = paths.index(f"['{n}']")
        ttab[n] = (ptabs[i][0], TMAP.threshold_table(v)[ptabs[i][1]])
        jtab[n] = (jnp.asarray(jtabs[i][0]),
                   JMAP.threshold_table(v)[jnp.asarray(jtabs[i][1])])
    q = rng.randn(B, 1, H, D).astype(np.float32)
    return tree, tt, tp, jtab, ttab, q


def _k3_kw(ttab, ecc, inject, word0=0):
    return dict(k_tables=ttab["k"], v_tables=ttab["v"], k_word0=word0,
                v_word0=word0, window=0, seed=TMAP.seed, method="word",
                words_per_row_log2=TMAP.words_per_row_log2, ecc=ecc,
                inject=inject, bkv=8)


@pytest.mark.parametrize("v,ecc", [(0.88, False), (0.87, True)])
def test_k3_plain_takes_per_row_device_positions(v, ecc):
    """K3's plain version with a (B,) q_pos that differs per row: each row
    equals the row alone (bits), equals the reference at that row's
    position with its clean slot (1e-5, float32), and reading through the
    masks equals attending over the write-path-corrupted cache with each
    row's own slot kept clean (bits)."""
    tree, tt, tp, jtab, ttab, q = _k3_setup(v, ecc)
    layer, wps = 1, KH * D
    word0 = layer * B * L * wps
    qpos = np.asarray([L + 5, 13], np.int32)         # slots 5 and 13
    k, vv, pos = tt["k"][layer], tt["v"][layer], tt["pos"][layer]
    tq = torch.from_numpy(q)
    got = faulty.faulty_decode_attention(
        tq, k, vv, pos, q_pos=torch.from_numpy(qpos),
        **_k3_kw(ttab, ecc, True, word0))
    for b in range(B):
        one = faulty.faulty_decode_attention(
            tq[b:b + 1], k[b:b + 1], vv[b:b + 1], pos[b:b + 1],
            q_pos=int(qpos[b]), **_k3_kw(ttab, ecc, True,
                                          word0 + b * L * wps))
        np.testing.assert_array_equal(_bits(one), _bits(got[b:b + 1]))
        ref = jfaulty.faulty_decode_attention(
            jnp.asarray(q[b:b + 1]), jnp.asarray(tree["k"][layer, b:b + 1]),
            jnp.asarray(tree["v"][layer, b:b + 1]),
            jnp.asarray(tree["pos"][layer, b:b + 1]), q_pos=int(qpos[b]),
            k_tables=jtab["k"], v_tables=jtab["v"],
            k_word0=jnp.uint32(word0 + b * L * wps),
            v_word0=jnp.uint32(word0 + b * L * wps), causal=True, window=0,
            seed=JMAP.seed, method="word",
            words_per_row_log2=JMAP.words_per_row_log2, ecc=ecc, inject=True,
            clean_slot=jnp.int32(qpos[b] % L), bkv=8, interpret=True)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    corr = {n: t.clone() for n, t in tt.items()}
    engine.inject_placement_slice(corr, tp, TMAP, voltage=v, method="word")
    kc, vc = corr["k"][layer].clone(), corr["v"][layer].clone()
    for b in range(B):
        s = int(qpos[b]) % L
        kc[b, s], vc[b, s] = k[b, s], vv[b, s]
    write = faulty.faulty_decode_attention(
        tq, kc, vc, pos, q_pos=torch.from_numpy(qpos),
        **_k3_kw(ttab, ecc, False, word0))
    np.testing.assert_array_equal(_bits(got), _bits(write))
    assert np.isfinite(got.numpy()).any()


# ---------------------------------------------------------------------------
# the write path at a device position
# ---------------------------------------------------------------------------


def _bits(t):
    return convert.tensor_to_numpy_bits(t)


def _write_tree(v, ecc):
    """A stacked float32 ring (K/V and pos) and a float32 carried state,
    placed in both packages."""
    rng = np.random.RandomState(5)
    tree = {"ring": {n: rng.randn(P, B, L, KH, D).astype(np.float32)
                     for n in ("k", "v")},
            "h": rng.randn(B, 24).astype(np.float32)}
    tree["ring"]["pos"] = np.tile(np.arange(L, dtype=np.int32), (P, B, 1))
    axes = {"ring": {"k": 2, "v": 2, "pos": 2}, "h": -1}
    domain = dict(name="d", voltage=v, pc_ids=tuple(range(6)), ecc=ecc)
    jp = jplace({"g": tree}, {"g": "d"}, {"d": JDomain(**domain)}, JGEO)["g"]
    tt = convert.cache_from_jax(tree)
    tp = place_groups({"g": tt}, {"g": "d"}, {"d": MemoryDomain(**domain)},
                      TGEO)["g"]
    return tree, tt, axes, jp, tp


def _inject(tree, axes, tp, v, method, pos):
    out = pytree.tree_map(lambda t: t.clone(), tree)
    _, bad = engine.inject_placement_slice(out, tp, TMAP, slot_axes=axes,
                                           pos=pos, voltage=v, method=method)
    return out, int(bad)


def _reference(tree, axes, jp, v, method, pos):
    """The reference's write path at int position ``pos``, as raw words."""
    jtree = pytree.tree_map(jnp.asarray, tree)
    out, bad = jengine.inject_placement_slice(
        jtree, jp, JMAP, slot_axes=axes, pos=jnp.int32(pos), voltage=v,
        method=method)
    words = {n: np.asarray(out["ring"][n]).view(np.uint32)
             for n in ("k", "v", "pos")}
    words["h"] = np.asarray(out["h"]).view(np.uint32)
    return words, int(bad)


def _words(t):
    return {**{n: _bits(t["ring"][n]) for n in ("k", "v", "pos")},
            "h": _bits(t["h"])}


@pytest.mark.parametrize("method,v,ecc", [("word", 0.87, False),
                                          ("bitwise", 0.86, False),
                                          ("word", 0.86, True)])
def test_device_position_write_path_equals_reference(method, v, ecc):
    """``inject_placement_slice`` at a 0-dim device position (and at an
    int) writes the reference's raw words and uncorrectable count at that
    position; at a (B,) per-row position each live row gets the
    reference's words at its own position, a row at -1 keeps its words,
    and leaves corrupted whole are corrupted as the reference does (and
    kept when no row is live)."""
    tree, tt, axes, jp, tp = _write_tree(v, ecc)
    want, jbad = _reference(tree, axes, jp, v, method, L + 7)
    for pos in (torch.tensor(L + 7), L + 7):
        got, bad = _inject(tt, axes, tp, v, method, pos)
        for n, w in want.items():
            np.testing.assert_array_equal(_words(got)[n], w, err_msg=n)
        assert bad == jbad
    fresh = _words(tt)
    assert any((want[n] != fresh[n]).any() for n in want)
    at11, _ = _reference(tree, axes, jp, v, method, 11)
    got, _ = _inject(tt, axes, tp, v, method,
                     torch.tensor([11, L + 7], dtype=torch.int32))
    for n, g in _words(got).items():
        if n == "h" or (ecc and n == "pos"):
            # no slot axis / a 1-word slot splits a codeword: whole leaf
            np.testing.assert_array_equal(g, want[n], err_msg=n)
            continue
        np.testing.assert_array_equal(g[:, 0], at11[n][:, 0], err_msg=n)
        np.testing.assert_array_equal(g[:, 1], want[n][:, 1], err_msg=n)
    got, _ = _inject(tt, axes, tp, v, method,
                     torch.tensor([11, -1], dtype=torch.int32))
    for n, g in _words(got).items():
        if n == "h" or (ecc and n == "pos"):
            np.testing.assert_array_equal(g, at11[n], err_msg=n)
            continue
        np.testing.assert_array_equal(g[:, 0], at11[n][:, 0], err_msg=n)
        np.testing.assert_array_equal(g[:, 1], fresh[n][:, 1], err_msg=n)
    idle, bad = _inject(tt, axes, tp, v, method, torch.tensor([-1, -1]))
    for n, g in _words(idle).items():
        np.testing.assert_array_equal(g, fresh[n], err_msg=n)
    assert bad == 0


# ---------------------------------------------------------------------------
# the step bodies on the CPU
# ---------------------------------------------------------------------------


_HOST_READS = {torch.ops.aten._local_scalar_dense.default,
               torch.ops.aten.nonzero.default,
               torch.ops.aten.lift_fresh.default}
_INDEX_OPS = {torch.ops.aten.index.Tensor, torch.ops.aten.index_put.default,
              torch.ops.aten.index_put_.default}


class _NoHostRead(TorchDispatchMode):
    """Raises on what a CUDA graph cannot hold: a scalar read of a tensor
    (``.item()``, ``int()``, ``bool()``), a boolean-mask index (a nonzero
    count read on the host) or a tensor made from host data (a host to
    device copy on the card)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _HOST_READS:
            raise AssertionError(f"the captured step body calls {func}")
        if func in _INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            raise AssertionError(f"the captured step body indexes with a "
                                 f"boolean mask ({func})")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _bodies_guarded(monkeypatch):
    """Every CapturedStep call runs its body under _NoHostRead; yields the
    list of steps called."""
    calls = []
    orig = captured.CapturedStep.__call__

    def guarded(self):
        calls.append(self)
        with _NoHostRead():
            return orig(self)

    monkeypatch.setattr(captured.CapturedStep, "__call__", guarded)
    yield calls


LB, RB = get_arch("llama3.2-3b"), get_arch("recurrentgemma-9b")
# the model zoo's families on each route: gemma3's window rings page,
# deepseek's MLA latent rings and routed experts, xLSTM's state, whisper's
# cross K/V and the VLM ride the state arena
ZOO = {"gemma3": get_arch("gemma3-4b"),
       "moe": get_arch("deepseek-v2-lite-16b"),
       "xlstm": get_arch("xlstm-350m"),
       "whisper": get_arch("whisper-large-v3"),
       "vlm": get_arch("internvl2-2b")}


def _extras(cfg, lead=()):
    """Seeded modality inputs of whisper (frames) and the VLM (patches),
    with leading axes ``lead``; none for the other families."""
    rng = np.random.RandomState(3)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            lead + (cfg.enc_len, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            lead + (cfg.enc_len, cfg.frontend_dim)).astype(np.float32)}
    return {}


@functools.lru_cache(maxsize=None)
def _llama():
    return LB.reduced, init_params(LB.module.param_specs(LB.reduced),
                                   torch.Generator().manual_seed(0),
                                   device="cpu")


@functools.lru_cache(maxsize=None)
def _hybrid():
    cfg = dataclasses.replace(RB.reduced, dtype=torch.float32)
    return cfg, init_params(RB.module.param_specs(cfg),
                            torch.Generator().manual_seed(0), device="cpu")


@functools.lru_cache(maxsize=None)
def _zoo(family):
    b = ZOO[family]
    cfg = dataclasses.replace(b.reduced, dtype=torch.float32)
    return cfg, init_params(b.module.param_specs(cfg),
                            torch.Generator().manual_seed(0), device="cpu")


def _plan(v, ecc=False):
    return UndervoltPlan(
        domains={"kv": MemoryDomain("kv", v, tuple(range(32)), ecc=ecc)},
        policy={"kv_cache": "kv"}, geometry=VCU128)


PROMPT = np.random.RandomState(2).randint(0, 256, (2, 9))


@pytest.mark.parametrize("family,v,ecc,mode,kw", [
    ("llama", 0.86, False, "read", {}),
    ("llama", 0.86, True, "write", {}),
    ("llama", 0.86, False, "rewrite", {"kv_method": "bitwise"}),
    ("llama", None, False, "auto", {"kv_tile": 8}),
    ("llama", 0.86, False, "write", {"temperature": 0.8}),
    ("hybrid", 0.86, False, "write", {}),
    ("hybrid", 0.87, True, "rewrite", {}),
    ("xlstm", 0.86, False, "write", {}),
    ("whisper", 0.86, False, "write", {}),
    ("vlm", 0.87, True, "write", {})])
def test_generate_step_body_reads_nothing_on_the_host(monkeypatch, family,
                                                      v, ecc, mode, kw):
    bundle, (cfg, params) = (
        (LB, _llama()) if family == "llama" else (RB, _hybrid())
        if family == "hybrid" else (ZOO[family], _zoo(family)))
    sc = ServeConfig(max_len=24, max_new_tokens=4, kv_injection=mode,
                     undervolt=None if v is None else _plan(v, ecc), **kw)
    batch = {"tokens": PROMPT % cfg.vocab, **_extras(cfg, (2,))}
    want = generate(bundle, cfg, params, batch, sc, device="cpu")
    with _bodies_guarded(monkeypatch) as calls:
        got = generate(bundle, cfg, params, batch, sc, device="cpu")
    assert len(calls) == 3 and len(set(map(id, calls))) == 1
    assert calls[0].traces == 1
    assert torch.equal(got, want)


def _sched(family, sc, reqs, device="cpu", **kw):
    """Two serving slots of the reduced family's scheduler (the paged one
    for llama, the state arena for recurrentgemma), ``reqs`` submitted."""
    bundle, (cfg, params) = (
        (LB, _llama()) if family == "llama" else (RB, _hybrid())
        if family == "hybrid" else (ZOO[family], _zoo(family)))
    sched = ContinuousBatchingScheduler(
        bundle, cfg, _on(device, params), sc, num_slots=2, num_pages=24,
        page_slots=8, device=device, **kw)
    for i, (toks, n) in enumerate(reqs):
        sched.submit(Request(rid=i, tokens=toks % cfg.vocab,
                             max_new_tokens=n, extras=_extras(cfg) or None))
    return sched


def _on(dev, params):
    return pytree.tree_map(lambda t: t.to(dev), params)


_R = np.random.RandomState(9)
SREQS = [(_R.randint(0, 256, (n,)), m)
         for n, m in ((5, 4), (9, 6), (3, 3), (7, 5))]


@pytest.mark.parametrize("family,mode,ecc", [("llama", "write", False),
                                             ("llama", "read", True),
                                             ("hybrid", "write", False),
                                             ("gemma3", "read", False),
                                             ("moe", "write", False),
                                             ("xlstm", "write", False),
                                             ("whisper", "write", False),
                                             ("vlm", "write", True)])
def test_scheduler_steps_read_nothing_on_the_host_and_trace_once(
        monkeypatch, family, mode, ecc):
    """Four requests through two slots (admissions, retirements, idle
    rows): the decode-only step body reads nothing on the host, and the
    scheduler builds it once (``decode_traces == 1``)."""
    sc = ServeConfig(max_len=24, max_new_tokens=4, undervolt=_plan(0.86, ecc),
                     kv_injection=mode, prefill_chunk=4)
    with _bodies_guarded(monkeypatch) as calls:
        sched = _sched(family, sc, SREQS)
        res = sched.run()
    assert len(res) == len(SREQS) and sched.admitted == len(SREQS)
    assert len(calls) > 1 and len(set(map(id, calls))) == 1
    assert sched.stats["decode_traces"] == 1


def test_sharded_scheduler_step_reads_nothing_on_the_host(monkeypatch):
    """Two logical shards of one slot each (ECC read): the decode-only
    body runs both shards' steps, reads nothing on the host, and is built
    once."""
    sc = ServeConfig(max_len=24, max_new_tokens=4, undervolt=_plan(0.86, True),
                     kv_injection="read", prefill_chunk=4)
    with _bodies_guarded(monkeypatch) as calls:
        sched = _sched("llama", sc, SREQS,
                       mesh=make_serve_mesh(2, devices=["cpu"] * 2))
        res = sched.run()
    assert {r.shard for r in res.values()} == {0, 1}
    assert len(calls) > 1 and len(set(map(id, calls))) == 1
    assert sched.stats["decode_traces"] == 1


def test_paged_idle_slot_pages_are_untouched():
    """The decode-only step with a slot at position -1 (its page-table
    row still mapping its pages): that slot's page words stay as they
    were, on every leaf, while the live slot's step writes its pages."""
    sc = ServeConfig(max_len=24, max_new_tokens=4, undervolt=_plan(0.86),
                     kv_injection="write", kv_method="bitwise",
                     prefill_chunk=16)
    sched = _sched("llama", sc, [(SREQS[0][0], 8), (SREQS[1][0], 8)])
    sched.admit_pending()
    sched.step_once()                     # both prompts prefilled
    assert all(sched._dec_h) and sched.n_active == 2

    def words(slot):
        pids = torch.from_numpy(np.asarray(sched._slot_priv[slot], np.int64))
        return [_bits(sched.kvc._leaf_arrays(sched.state["pool"], leaf)[
            :, pids]) for leaf in sched.pool.leaves]

    idle_before, live_before = words(1), words(0)
    s = sched.num_slots
    sched._decode.load(tok=np.asarray([[sched._tok_h[0]], [0]], np.int64),
                       pos=np.asarray([sched._qpos_h[0], -1], np.int32),
                       wstart=np.asarray(sched._wstart_h[:s], np.int32))
    with torch.no_grad():
        sched._decode()
    for a, b in zip(idle_before, words(1)):
        np.testing.assert_array_equal(a, b)
    assert any((a != b).any() for a, b in zip(live_before, words(0)))


# ---------------------------------------------------------------------------
# on the card: captured == eager on bits, launches unchanged
# ---------------------------------------------------------------------------


def _recorder(bundle):
    """``bundle`` with a module that records the cache its decode steps
    write (the generate() cache, for its words)."""
    seen = {}

    class _Module:
        def __getattr__(self, name):
            return getattr(bundle.module, name)

        def decode_step(self, params, cache, *args, **kwargs):
            seen["cache"] = cache
            return bundle.module.decode_step(params, cache, *args, **kwargs)

    return dataclasses.replace(bundle, module=_Module()), seen


def _assert_words_equal(a, b):
    for x, y in zip(pytree.leaves(a), pytree.leaves(b)):
        np.testing.assert_array_equal(_bits(x.cpu()), _bits(y.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("family,v,ecc,mode", [
    ("llama", 0.86, False, "write"), ("llama", 0.86, True, "read"),
    ("llama", None, False, "auto"), ("hybrid", 0.86, False, "write"),
    ("hybrid", 0.86, False, "rewrite")])
def test_captured_generate_equals_eager_on_card(cuda_device, family, v, ecc,
                                                mode):
    bundle, (cfg, params) = (
        (LB, _llama()) if family == "llama" else (RB, _hybrid())
        if family == "hybrid" else (ZOO[family], _zoo(family)))
    params = _on(cuda_device, params)
    sc = ServeConfig(max_len=40, max_new_tokens=8, kv_injection=mode,
                     undervolt=None if v is None else _plan(v, ecc))
    out = {}
    for capture in (False, True):
        rec, seen = _recorder(bundle)
        _build.reset_launch_counts()
        toks = generate(rec, cfg, params, {"tokens": PROMPT % cfg.vocab}, sc,
                        device=cuda_device, capture=capture)
        out[capture] = (toks.cpu(), seen["cache"], _build.launch_counts())
    assert torch.equal(out[False][0], out[True][0])
    _assert_words_equal(out[False][1], out[True][1])
    assert out[False][2] == out[True][2]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["llama", "hybrid"])
def test_captured_schedulers_equal_eager_on_card(cuda_device, family):
    sc = ServeConfig(max_len=24, max_new_tokens=4, undervolt=_plan(0.86),
                     kv_injection="write", prefill_chunk=4)
    out = {}
    for capture in (False, True):
        sched = _sched(family, sc, SREQS, device=cuda_device,
                       capture=capture)
        _build.reset_launch_counts()
        res = sched.run()
        out[capture] = ({r: res[r].tokens for r in res}, sched.state,
                        _build.launch_counts(), sched.stats)
    for r in out[False][0]:
        np.testing.assert_array_equal(out[False][0][r], out[True][0][r])
    _assert_words_equal(out[False][1], out[True][1])
    assert out[False][2] == out[True][2]
    assert out[True][3]["decode_traces"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("inject", [False, True])
def test_k3_kernel_reads_per_row_device_positions(cuda_device, inject):
    """K3 with a (B,) device q_pos differing per row equals its plain
    version and, on bits, each row launched alone."""
    _, tt, _, _, ttab, q = _k3_setup(0.87, False)
    dev = lambda t: t.to(cuda_device)  # noqa: E731
    tabs = {n: tuple(dev(t) for t in ttab[n]) for n in ttab}
    k, vv, pos = (dev(tt[n][1]).contiguous() for n in ("k", "v", "pos"))
    tq = dev(torch.from_numpy(q))
    qpos = dev(torch.tensor([L + 5, 13], dtype=torch.int32))
    wps = KH * D
    _build.reset_launch_counts()
    got = faulty.faulty_decode_attention(tq, k, vv, pos, q_pos=qpos,
                                         **_k3_kw(tabs, False, inject))
    assert _build.launch_counts()["faulty_decode"] == 1
    ref = faulty.faulty_decode_attention_ref(tq, k, vv, pos, q_pos=qpos,
                                             **_k3_kw(tabs, False, inject))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5,
                               equal_nan=True)
    for b in range(B):
        one = faulty.faulty_decode_attention(
            tq[b:b + 1], k[b:b + 1], vv[b:b + 1], pos[b:b + 1],
            q_pos=qpos[b:b + 1], **_k3_kw(tabs, False, inject, b * L * wps))
        np.testing.assert_array_equal(_bits(one.cpu()),
                                      _bits(got[b:b + 1].cpu()))


@pytest.mark.cuda
def test_captured_steps_survive_drop_and_recapture_under_gc_pressure(
        cuda_device):
    """Schedulers of both families and generate() requests made, run and
    dropped in a loop, each dead one held in a reference cycle (so only
    the cyclic collector frees it, its graph included), with the collector
    set to run at nearly every allocation: no collection starts while a
    step is being captured (one that tore a dead graph down there would
    invalidate the capture), every capture succeeds and every run gives
    the first run's tokens."""
    import gc
    sc = ServeConfig(max_len=24, max_new_tokens=4, undervolt=_plan(0.86),
                     kv_injection="write", prefill_chunk=4)
    cfg, params = _llama()
    params = _on(cuda_device, params)
    batch = {"tokens": PROMPT % cfg.vocab}
    first, during_capture = {}, []

    def watch(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            during_capture.append(info["generation"])

    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    gc.callbacks.append(watch)
    try:
        for _ in range(4):
            for family in ("llama", "hybrid"):
                sched = _sched(family, sc, SREQS, device=cuda_device)
                res = sched.run()
                toks = {r: np.asarray(res[r].tokens).tolist() for r in res}
                assert first.setdefault(family, toks) == toks
                assert sched.stats["decode_traces"] == 1
                sched.cycle = sched
                del sched
            toks = generate(LB, cfg, params, batch, sc,
                            device=cuda_device).cpu()
            assert torch.equal(first.setdefault("generate", toks), toks)
    finally:
        gc.callbacks.remove(watch)
        gc.set_threshold(*threshold)
        gc.collect()
    assert during_capture == []
