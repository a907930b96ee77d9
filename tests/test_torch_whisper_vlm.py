"""The port's whisper (``models/whisper.py``) and InternVL2 (``models/vlm.py``)
families held against the JAX reference, on the reduced configs in
float32, and the state-arena scheduler's modality inputs and prefill
reuse.

Weights and the modality inputs (whisper's frames, the VLM's patches) are
made with numpy from a seed and handed to both packages.  The encoder,
the cross-attention, the multimodal embedding, prefill and decode logits
and caches agree within 1e-5 (relative to the largest magnitude); greedy
``generate()`` tokens equal the reference's clean, at 0.86 V with
bitwise write-path injection and at 0.875 V with ECC; the write path's
whole-leaf injection of whisper's cross K/V equals the reference's on raw
uint32 words; ``forward_train`` loss and gradients agree.  Inside the
port: every state-arena request (with extras) equals its solo replay,
the front door's routes and layouts, the reference's prefill-reuse test,
and a reused prefill that leaves each slot with the faults of its own
placement.
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
from repro.models import vlm as jvlm
from repro.models import whisper as jwhisper
from repro.serving import engine as jserve
from repro.training.undervolt import UndervoltPlan as JPlan

from repro_torch import convert
from repro_torch.core import engine, pytree
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.hbm import VCU128
from repro_torch.models import base, vlm, whisper
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.serving.statearena import StateArenaScheduler, _rows
from repro_torch.training.undervolt import UndervoltPlan

RTOL = 1e-5
# float32 gradients, held relative to each leaf's largest entry
GRAD_RTOL = 1e-4
MAX_LEN, NEW = 32, 5
NAMES = ("whisper-large-v3", "internvl2-2b")
V_DEEP = 0.86


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


@functools.lru_cache(maxsize=None)
def _params(name):
    """(JAX tree, torch tree) of one numpy init (the reference's rules)."""
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


def _extras(cfg, rng, batch=None):
    """The family's modality inputs (a leading batch axis if ``batch``)."""
    lead = () if batch is None else (batch,)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            lead + (cfg.enc_len, cfg.d_model)).astype(np.float32)}
    return {"patches": rng.standard_normal(
        lead + (cfg.enc_len, cfg.frontend_dim)).astype(np.float32)}


def _batch(name, b=2, s=7, seed=1):
    _, jcfg, _, _ = _cfgs(name)
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, jcfg.vocab, (b, s)).astype(np.int32),
            **_extras(jcfg, rng, b)}


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


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", NAMES)
def test_config_and_layouts_match_reference(name):
    """CFG and REDUCED field for field; cache specs, slot and batch axes,
    layouts (whisper's ck / cv are ``cross``) and parameter trees equal
    the reference's."""
    jb, jcfg, tb, tcfg = _cfgs(name)
    for want, got in ((jb.cfg, tb.cfg), (jb.reduced, tb.reduced)):
        for f in dataclasses.fields(got):
            a, b = getattr(want, f.name), getattr(got, f.name)
            if f.name == "dtype":
                assert str(b).rsplit(".", 1)[-1] == jnp.dtype(a).name
            else:
                assert a == b, (f.name, a, b)
    jspecs = jb.module.cache_specs(jcfg, 3, MAX_LEN)
    tspecs = tb.module.cache_specs(tcfg, 3, MAX_LEN)
    js, ts = _jleaves(jspecs), _leaves(tspecs)
    assert sorted(js) == sorted(ts)
    for k in js:
        assert js[k].shape == ts[k].shape and js[k].axes == ts[k].axes, k
    for jfn, tfn in ((jbase.cache_slot_axes, base.cache_slot_axes),
                     (jbase.cache_batch_axes, base.cache_batch_axes)):
        assert _jleaves(jfn(jspecs)) == _leaves(tfn(tspecs))
    lay = _leaves(base.cache_layouts(tspecs, MAX_LEN))
    assert lay == _jleaves(jbase.cache_layouts(jspecs, MAX_LEN))
    want = {"full", "cross"} if tcfg.family == "audio" else {"full"}
    assert set(lay.values()) == want
    assert _jleaves(jb.module.param_specs(jcfg)).keys() == _leaves(
        tb.module.param_specs(tcfg)).keys()


def test_encode_and_cross_attend_match_reference():
    """Whisper's encoder over 12 frames, then one decoder layer's
    cross-attention of 5 queries over the encoder K/V."""
    _, jcfg, _, tcfg = _cfgs(NAMES[0])
    jp, tp = _params(NAMES[0])
    frames = _batch(NAMES[0])["frames"]
    jenc = jax.jit(lambda p_, f_: jwhisper.encode(p_, f_, jcfg))(
        jp, jnp.asarray(frames))
    tenc = whisper.encode(tp, torch.from_numpy(frames), tcfg)
    _close(tenc.detach().numpy(), jenc, "encode")
    jl = {k: v[0] for k, v in jp["dec_stack"]["periods"]["s0_dec"].items()}
    tl = {k: v[0] for k, v in tp["dec_stack"]["periods"]["s0_dec"].items()}
    x = np.random.RandomState(2).standard_normal(
        (2, 5, jcfg.d_model)).astype(np.float32)
    ck = np.asarray(jenc) @ np.asarray(jl["xk"])
    cv = np.asarray(jenc) @ np.asarray(jl["xv"])
    shape = (2, jcfg.enc_len, jcfg.n_kv_heads, jcfg.head_dim)
    ck, cv = ck.reshape(shape), cv.reshape(shape)
    want = jax.jit(lambda p_, *a: jwhisper._cross_attend(jcfg, p_, *a))(
        jl, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv))
    for serving in (True, False):
        got = whisper._cross_attend(tcfg, tl, torch.from_numpy(x),
                                    torch.from_numpy(ck),
                                    torch.from_numpy(cv), serving=serving)
        _close(got.detach().numpy(), want, f"cross serving={serving}")


def test_embed_multimodal_matches_reference():
    """The VLM's projected image tokens followed by the text embeddings."""
    _, jcfg, _, tcfg = _cfgs(NAMES[1])
    jp, tp = _params(NAMES[1])
    batch = _batch(NAMES[1])
    want = jax.jit(lambda p_, b_: jvlm._embed_multimodal(p_, b_, jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    for serving in (True, False):
        got = vlm._embed_multimodal(tp, _torch_batch(batch), tcfg,
                                    serving=serving)
        assert got.shape == (2, jcfg.enc_len + 7, jcfg.d_model)
        _close(got.detach().numpy(), want, f"embed serving={serving}")


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_reference(name):
    """Prefill logits and cache, then two decode steps' logits and cache
    (the VLM's positions start after its image tokens)."""
    jb, jcfg, tb, tcfg = _cfgs(name)
    jp, tp = _params(name)
    batch = _batch(name)
    jl, jc = jax.jit(lambda p_, b_: jb.module.prefill(
        p_, b_, jcfg, MAX_LEN))(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    tl, tc = tb.module.prefill(tp, _torch_batch(batch), tcfg, MAX_LEN)
    _close(tl.numpy(), jl, "prefill logits")
    pos0 = 7 + (jcfg.enc_len if jcfg.family == "vlm" else 0)
    step = jax.jit(lambda p_, c_, t_, pos: jb.module.decode_step(
        p_, c_, {"tokens": t_}, pos, jcfg))
    tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    for i in range(2):
        jl, jc = step(jp, jc, jnp.asarray(tok), jnp.int32(pos0 + i))
        tl, tc = tb.module.decode_step(tp, tc, {"tokens": torch.from_numpy(
            tok).long()}, pos0 + i, tcfg)
        _close(tl.numpy(), jl, f"decode {i} logits")
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    tleaves = _leaves(tc)
    for k, want in _jleaves(jc).items():
        if np.asarray(want).dtype == np.int32:
            np.testing.assert_array_equal(tleaves[k].numpy(), want, k)
        else:
            _close(tleaves[k].numpy(), want, f"cache {k}")


@pytest.mark.parametrize("v,ecc,method", [(None, False, "auto"),
                                          (V_DEEP, False, "bitwise"),
                                          (0.875, True, "auto")],
                         ids=["clean", "0.86-bitwise", "0.875-ecc"])
@pytest.mark.parametrize("name", NAMES)
def test_generate_matches_reference(name, v, ecc, method):
    """Greedy generate() tokens (batch 2, extras batched) equal the
    reference's; the injected runs take the write path ('auto')."""
    jb, jcfg, tb, tcfg = _cfgs(name)
    jp, tp = _params(name)
    batch = _batch(name)
    jplan, tplan = (None, None) if v is None else _plans(v, ecc)
    want = np.asarray(jserve.generate(
        jb, jcfg, jp, {k: jnp.asarray(x) for k, x in batch.items()},
        jserve.ServeConfig(max_len=MAX_LEN, max_new_tokens=NEW,
                           undervolt=jplan, kv_method=method)))
    timings = {}
    got = generate(tb, tcfg, tp, batch, ServeConfig(
        max_len=MAX_LEN, max_new_tokens=NEW, undervolt=tplan,
        kv_method=method), device="cpu", timings=timings)
    np.testing.assert_array_equal(got.numpy(), want)
    assert timings["mode"] == ("clean" if v is None else "write")


def test_cross_leaves_write_path_injection_matches_reference_on_words(
        monkeypatch):
    """The step's write-path injection corrupts whisper's cross K/V whole
    and its self-attention rings only at the written slot, equal to the
    reference's ``inject_placement_slice`` on raw uint32 words (word
    method, 0.84 V), on a prefilled cache, also when a whole leaf is
    corrupted in passes of 256 words (as full-width leaves are, in passes
    of ``FULL_LEAF_WORDS``); a second step leaves the cross words as they
    are (stuck-at idempotence)."""
    jb, jcfg, tb, tcfg = _cfgs(NAMES[0])
    _, tp = _params(NAMES[0])
    jspecs = jb.module.cache_specs(jcfg, 1, MAX_LEN)
    tspecs = tb.module.cache_specs(tcfg, 1, MAX_LEN)
    jplan, tplan = _plans(0.84, False)
    jplc = jplan.place({"kv_cache": jbase.spec_avals(jspecs)})["kv_cache"]
    tplc = tplan.place({"kv_cache": base.spec_avals(tspecs)})["kv_cache"]
    batch = _batch(NAMES[0], b=1)
    _, cache = tb.module.prefill(tp, _torch_batch(batch), tcfg, MAX_LEN)
    words = {k: convert.tensor_to_numpy_bits(x).copy()
             for k, x in _leaves(cache).items()}
    javals = jbase.spec_avals(jspecs)
    flat = jax.tree_util.tree_flatten_with_path(javals)[0]
    jtree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(javals),
        [jnp.asarray(words[jax.tree_util.keystr(p)].view(a.dtype))
         for p, a in flat])
    jstep, _ = jax.jit(lambda t: jengine.inject_placement_slice(
        t, jplc, jplan.fault_map(), slot_axes=jbase.cache_slot_axes(jspecs),
        pos=jnp.int32(6), voltage=jnp.float32(0.84), method="word"))(jtree)
    jstep = _jleaves(jax.tree.map(np.asarray, jstep))
    kw = dict(slot_axes=base.cache_slot_axes(tspecs), voltage=0.84,
              method="word")
    passes = pytree.tree_map(lambda t: t.clone(), cache)
    engine.inject_placement_slice(cache, tplc, tplan.fault_map(), pos=6, **kw)
    got = {k: convert.tensor_to_numpy_bits(x).copy()
           for k, x in _leaves(cache).items()}
    monkeypatch.setattr(engine, "FULL_LEAF_WORDS", 256)
    engine.inject_placement_slice(passes, tplc, tplan.fault_map(), pos=6,
                                  **kw)
    monkeypatch.undo()
    for k, x in _leaves(passes).items():
        np.testing.assert_array_equal(convert.tensor_to_numpy_bits(x),
                                      got[k], err_msg=k)
    engine.inject_placement_slice(cache, tplc, tplan.fault_map(), pos=7,
                                  **kw)
    again = {k: convert.tensor_to_numpy_bits(x)
             for k, x in _leaves(cache).items()}
    cross_changed = 0
    for k, g in got.items():
        np.testing.assert_array_equal(g, jstep[k].view(g.dtype), err_msg=k)
        if k.endswith(("['ck']", "['cv']")):
            np.testing.assert_array_equal(again[k], g, err_msg=k)
            cross_changed += int((g != words[k]).sum())
    assert cross_changed > 0, "no cross word faulted at 0.84 V: vacuous"


# ---------------------------------------------------------------------------
# the state-arena scheduler: extras, positions, prefill reuse
# ---------------------------------------------------------------------------


def _requests(cfg, n=3, seed=4):
    rng = np.random.RandomState(seed)
    return [(f"r{i}", rng.randint(0, cfg.vocab, (4 + 3 * i,)), 3 + i,
             _extras(cfg, np.random.RandomState(10 + i)))
            for i in range(n)]


def _serve(name, sc, reqs, num_slots=2):
    _, _, tb, tcfg = _cfgs(name)
    sched = ContinuousBatchingScheduler(tb, tcfg, _params(name)[1], sc,
                                        num_slots=num_slots, device="cpu")
    assert isinstance(sched, StateArenaScheduler)
    for rid, toks, n, extras in reqs:
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=n,
                             extras=extras))
    return sched, sched.run()


def _replay(name, sc, reqs, res):
    _, _, tb, tcfg = _cfgs(name)
    out = {}
    for rid, toks, n, extras in reqs:
        batch = {"tokens": np.asarray(toks)[None],
                 **{k: np.asarray(v)[None] for k, v in extras.items()}}
        out[rid] = generate(tb, tcfg, _params(name)[1], batch,
                            dataclasses.replace(sc, max_new_tokens=n),
                            device="cpu",
                            kv_placement=res[rid].placement).numpy()
    return out


@pytest.mark.parametrize("name", NAMES)
def test_state_arena_requests_equal_their_replays(name):
    """Two slots, three overlapping requests with their extras at 0.86 V
    write: each equals its solo generate(kv_placement=) replay, the step
    was traced once, and the VLM's query positions started after its
    image tokens (its ring holds them)."""
    _, _, _, tcfg = _cfgs(name)
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=4,
                     undervolt=_plan(V_DEEP), kv_injection="write",
                     kv_method="bitwise")
    reqs = _requests(tcfg)
    sched, res = _serve(name, sc, reqs)
    st = sched.stats
    assert st["decode_traces"] == 1 and st["prefill_reuse"] == 0
    refs = _replay(name, sc, reqs, res)
    for rid, *_ in reqs:
        np.testing.assert_array_equal(res[rid].tokens, refs[rid], rid)
        assert res[rid].pages_shared == 0
    if tcfg.family == "vlm":
        # the last step decodes the last request's last token
        _, toks, n, _ = reqs[-1]
        assert int(sched._decode.inputs["pos"].max()) == (
            tcfg.enc_len + len(toks) + n - 2)


def test_zoo_routes():
    """The front door sends the three families to the state arena, with
    the reference's cache layouts; a VLM request whose image tokens do
    not fit ``max_len`` is refused at submit, and the paged route still
    refuses extras (the reference's ``test_paged_route_rejects_extras``)."""
    for name, lay in (("xlstm-350m", ["state"]),
                      ("whisper-large-v3", ["cross", "full"]),
                      ("internvl2-2b", ["full"])):
        tb = base.get_arch(name)
        tcfg = dataclasses.replace(tb.reduced, dtype=torch.float32)
        params = base.init_params(tb.module.param_specs(tcfg),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
        s = ContinuousBatchingScheduler(
            tb, tcfg, params, ServeConfig(max_len=MAX_LEN, max_new_tokens=2),
            num_slots=2, num_pages=8, page_slots=8, device="cpu")
        assert isinstance(s, StateArenaScheduler), name
        assert s.stats["route"] == "state", name
        assert s.stats["cache_layouts"] == lay, name
    cfg = s.cfg
    with pytest.raises(ValueError, match="image tokens"):
        s.submit(Request("big", np.zeros((MAX_LEN - cfg.enc_len - 1,),
                                         np.int64), 2,
                         extras=_extras(cfg, np.random.RandomState(0))))
    s.submit(Request("fits", np.zeros((MAX_LEN - cfg.enc_len - 2,),
                                      np.int64), 2,
                     extras=_extras(cfg, np.random.RandomState(0))))
    assert len(s.queue) == 1
    lb = base.get_arch("llama3.2-3b")
    lcfg = dataclasses.replace(lb.reduced, dtype=torch.float32)
    paged = ContinuousBatchingScheduler(
        lb, lcfg, base.init_params(lb.module.param_specs(lcfg),
                                   torch.Generator().manual_seed(0),
                                   device="cpu"),
        ServeConfig(max_len=MAX_LEN, max_new_tokens=2), num_slots=2,
        num_pages=8, page_slots=8, device="cpu")
    assert not isinstance(paged, StateArenaScheduler)
    with pytest.raises(ValueError, match="extras"):
        paged.submit(Request("x", np.arange(4), 2,
                             extras={"frames": np.zeros((2, 4))}))


def test_whisper_prefill_reuse():
    """share_prefix on the state route: identical (tokens, frames)
    admissions reuse the prefill result -- the encoder runs once -- with
    identical tokens out, pages_shared flagging the reuse and the
    admission events carrying it (the reference's test of that name)."""
    name = NAMES[0]
    _, _, tb, tcfg = _cfgs(name)
    rng = np.random.RandomState(6)
    toks = rng.randint(0, tcfg.vocab, (5,))
    frames = _extras(tcfg, rng)
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=3, share_prefix=True)
    calls = []
    sched = ContinuousBatchingScheduler(tb, tcfg, _params(name)[1], sc,
                                        num_slots=3, device="cpu")
    orig = sched._prefill
    sched._prefill = lambda batch: calls.append(1) or orig(batch)
    for i in range(3):
        sched.submit(Request(rid=i, tokens=toks, max_new_tokens=3,
                             extras=frames))
    res = sched.run()
    assert sched.prefill_reuse == 2 and len(calls) == 1, sched.stats
    assert sched.stats["prefill_reuse"] == 2
    assert [res[i].pages_shared for i in range(3)] == [0, 1, 1]
    for i in (1, 2):
        np.testing.assert_array_equal(res[0].tokens, res[i].tokens)
    admits = sched.trace.events("admission")
    assert [e.data["prefill_reused"] for e in admits] == [False, True, True]


def test_prefill_reuse_keeps_each_slots_faults():
    """Three identical admissions under share_prefix at 0.86 V write reuse
    one cached prefill across slots on different placements: the cached
    tree comes out of every admission unchanged (bits equal to a fresh
    prefill), each slot's admitted row carries the faults of its own
    placement (== ``inject_group`` of a fresh prefill on that placement,
    and unlike the other slot's), and every request equals its solo
    replay without reuse."""
    name = NAMES[0]
    _, _, tb, tcfg = _cfgs(name)
    _, tp = _params(name)
    rng = np.random.RandomState(7)
    toks = rng.randint(0, tcfg.vocab, (5,))
    frames = _extras(tcfg, rng)["frames"]
    sc = ServeConfig(max_len=MAX_LEN, max_new_tokens=1, share_prefix=True,
                     undervolt=_plan(V_DEEP), kv_injection="write",
                     kv_method="bitwise")
    sched = ContinuousBatchingScheduler(tb, tcfg, tp, sc, num_slots=2,
                                        device="cpu")
    batch = {"tokens": torch.from_numpy(toks)[None].long(),
             "frames": torch.from_numpy(frames)[None]}
    _, fresh = tb.module.prefill(tp, batch, tcfg, MAX_LEN)

    def bits(tree):
        return [convert.tensor_to_numpy_bits(x).copy()
                for x in pytree.leaves(tree)]

    rows = {}
    for i in range(3):
        sched._admit(Request(rid=i, tokens=toks, max_new_tokens=1,
                             extras={"frames": frames}), i % 2)
        rows[i] = bits(_rows(sched.state["cache"], sched.batch_axes, i % 2))
    assert sched.prefill_reuse == 2
    (_, cached), = sched._prefill_cache.values()
    for a, b in zip(bits(cached), bits(fresh)):
        np.testing.assert_array_equal(a, b)
    from repro_torch.core.injection import inject_group
    for s in (0, 1):
        want, _ = inject_group(fresh, sched.placements[s], sched.fmap,
                               voltage=V_DEEP, method="bitwise")
        for a, b in zip(rows[s], bits(want)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(rows[2], rows[0]):
        np.testing.assert_array_equal(a, b)
    assert any((a != b).any() for a, b in zip(rows[0], rows[1])), (
        "both slots carry the same words: the placements do not differ")
    reqs = [(i, toks, 1, {"frames": frames}) for i in range(3)]
    refs = _replay(name, dataclasses.replace(sc, share_prefix=False), reqs,
                   sched.results)
    for i in range(3):
        np.testing.assert_array_equal(sched.results[i].tokens, refs[i])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_forward_train_matches_reference(name):
    """float32 loss within 1e-5 relative and every gradient leaf within
    1e-4 of its largest entry (the VLM's loss over its text positions)."""
    jb, jcfg, tb, tcfg = _cfgs(name)
    jp, tp = _params(name)
    batch = _batch(name, s=9, seed=5)
    jl, jg = jax.jit(jax.value_and_grad(lambda p_, b_: jb.module.forward_train(
        p_, b_, jcfg)[0]))(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = pytree.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tl, metrics = tb.module.forward_train(tp, _torch_batch(batch), tcfg)
    assert metrics["loss"] is tl
    _close(tl.detach().numpy(), jl, "loss")
    grads = torch.autograd.grad(tl, pytree.leaves(tp))
    for (path, a), g in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            grads):
        _close(g.numpy(), a, jax.tree_util.keystr(path), GRAD_RTOL)
