"""Meshes over ranks: the port's process meshes (two ranks over gloo on
the CPU) held against its logical meshes and against the reference.

The ranks run in one module-scoped launch
(``python -m repro_torch.launch.rankwork``, two subprocesses with a
timeout each, a free port, one torch thread each; they import no JAX),
beside the reference's 2-shard scheduler and its (1, 2) and (2, 1)
``shard_map`` train steps in a subprocess with two forced host devices.
Tolerances: on bits everywhere except the data-rank training mesh,
which sums its ranks' gradients in another order than the logical
mesh's one backward (parameters and moments within 1e-5 + 1e-5
|logical|, losses within 1e-6 relative), and training against the
reference's ``shard_map`` (below).

- ``psum_model`` over model ranks == the logical shard-order sum, forward
  and backward, and ``model_grad_sum`` sums the cotangent in rank order.
- The 2-rank paged fleet (reduced llama3.2-3b, one shard a rank) == the
  logical 2-shard scheduler: read, ECC write, governed with setpoints
  (1e-9, 1e-4), sampled: tokens, shards, page ids, per-shard voltages
  and stats; every request == its solo replay on its rank; and the
  rank fleet on the reference's float32 init == the reference's 2-shard
  scheduler.
- (1, 2) model-rank training of reduced float32 deepseek-v2-lite with an
  ECC plan and 2 microbatches == the logical (1, 2) mesh on bits for 2
  steps (loss, fault counts, parameters, moments); (2, 1) data ranks
  within the tolerance above; (1, 2) and (2, 1) ranks (no plan) against
  the reference's ``shard_map`` train step on the same mesh shape,
  losses within 1e-5 relative, moments within 1e-5 + 1e-5 |ref|, each
  parameter leaf's update within 1e-2 relative L2;
  checkpoints cross layouts on bits; the rank placement puts a rank's
  expert words at the logical words.
- The examples: ``tradeoff_explorer`` prints the reference example's
  text, ``resilient_inference`` gives the reference's greedy agreement
  at one voltage, ``serve_many --devices 2`` over 2 ranks serves what 2
  logical shards serve.
"""
import contextlib
import dataclasses
import io
import json
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.base import get_arch as jget_arch
from repro.models.base import init_params as jinit_params

from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import pytree
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.engine import inject_groups
from repro_torch.core.hbm import VCU128
from repro_torch.data.pipeline import DataConfig, make_batch, rank_rows
from repro_torch.examples import resilient_inference, serve_many
from repro_torch.examples import tradeoff_explorer
from repro_torch.launch import ranks, rankwork
from repro_torch.launch.mesh import (ShardLayoutError, make_mesh_auto,
                                     make_serve_mesh)
from repro_torch.launch.rankstate import (join_states, rank_placement,
                                          split_state, state_expert_dims)
from repro_torch.models import dist as D
from repro_torch.models.base import get_arch, init_params, spec_avals
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serving.engine import ServeConfig
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.training import trainer
from repro_torch.training.undervolt import UndervoltPlan

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 420
LITE = "deepseek-v2-lite-16b"
ADAMW = dict(lr=3e-3, warmup_steps=2, total_steps=50)
DATA = dict(vocab=257, seq_len=12, global_batch=4, seed=3)
TRAIN_STEPS = 2
PARAM_TOL = 1e-5
LOSS_RTOL = 1e-6
# ranks against the reference's shard_map: another implementation, on
# the schedule of the port's other reference training tests (a longer
# warmup: AdamW's first steps move each weight by ~lr * sign(g), so a
# gradient near zero that two implementations round apart would move it
# by up to 2 lr)
REF_ADAMW = dict(lr=3e-3, warmup_steps=10, total_steps=200)
REF_TOL = 1e-5
REF_LOSS_RTOL = 1e-5
# ... so parameters are held on their update from the shared init: each
# leaf's within this relative L2 gap of the reference's (measured: 1.3e-3
# at most, one unembedding word of 16,448)
REF_UPDATE_GAP = 1e-2
TB = get_arch("llama3.2-3b")
CFG = TB.reduced                          # bf16, 2 layers
SCHED = dict(num_slots=4, num_pages=16, page_slots=8)
_R = np.random.RandomState(7)
# (rid, prompt, max_new_tokens, tier, generator seed)
REQS = [(str(i), _R.randint(0, CFG.vocab, (6 + i,)).tolist(), 4, "cheap",
         100 + i) for i in range(6)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv_plan(v=0.88, ecc=False):
    return UndervoltPlan(
        domains={"kv": MemoryDomain("kv", v, tuple(range(32)), ecc=ecc)},
        policy={"kv_cache": "kv"}, geometry=VCU128)


def _train_plan():
    """Parameters in an ECC'd cheap domain at 0.88 V, moments safe."""
    return UndervoltPlan(
        domains={"safe": MemoryDomain("safe", 0.98, tuple(range(16))),
                 "cheap": MemoryDomain("cheap", 0.88, tuple(range(16, 32)),
                                       ecc=True)},
        policy={"params": "cheap", "mu": "safe", "nu": "safe"},
        geometry=VCU128)


FLEETS = {
    "read": dict(plan=_kv_plan(), serve=dict(kv_injection="read",
                                             kv_method="bitwise")),
    "ecc-write": dict(plan=_kv_plan(0.88, True),
                      serve=dict(kv_injection="write", kv_method="word")),
    "governed": dict(plan=_kv_plan(0.91), setpoints=[1e-9, 1e-4],
                     governor=dict(domain="kv", mode="rate",
                                   tolerable_rate=1e-3, v_lo=0.87),
                     serve=dict(kv_injection="read", kv_method="word")),
    "sampled": dict(plan=_kv_plan(), serve=dict(
        kv_injection="read", kv_method="bitwise", temperature=0.8)),
}
# the reference's governed 2-shard cell, on its float32 init, and its
# (1, 2) and (2, 1) train steps from the ranks' init
REF_SPEC = dict(v=0.91, v_lo=0.87, setpoints=[1e-9, 1e-4],
                reqs=[(rid, toks, n) for rid, toks, n, *_ in REQS[:4]],
                adamw=REF_ADAMW, steps=TRAIN_STEPS)
LAUNCH_ARGS = ["--arch", LITE, "--device", "cpu", "--seq", "16", "--batch",
               "4", "--steps", "3", "--undervolt", "0.93"]


def _fleet_run(name, c, init, requests=REQS, overrides=None):
    return dict(kind="fleet", name=name, arch="llama3.2-3b", init=init,
                overrides=overrides, n_shards=2, sched=SCHED,
                plan=rankwork.plan_spec(c["plan"]),
                governor=c.get("governor"),
                shard_setpoints=c.get("setpoints"),
                serve=dict(max_len=32, max_new_tokens=4, **c["serve"]),
                requests=requests)


def _train_run(name, mesh, **kw):
    return {**dict(kind="train", name=name, arch=LITE,
                   overrides={"dtype": "float32"},
                   init={"seed": 0, "on_host": True}, mesh=list(mesh),
                   adamw=ADAMW, data=DATA, steps=TRAIN_STEPS, dump="npz"),
            **kw}


def _lite():
    b = get_arch(LITE)
    return b, dataclasses.replace(b.reduced, dtype=torch.float32)


def _logical_train(mesh, plan=None, microbatches=1, steps=TRAIN_STEPS):
    """The logical mesh's run from the ranks' init: (state, metrics per
    step)."""
    bundle, cfg = _lite()
    st = trainer.init_state(bundle, cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    dist = D.DistContext(mesh=make_mesh_auto(mesh, ("data", "model"),
                                             device="cpu"))
    step = trainer.make_train_step(bundle, cfg, trainer.TrainConfig(
        microbatches=microbatches, adamw=AdamWConfig(**ADAMW),
        undervolt=plan), dist)
    hist = []
    for i in range(steps):
        st, m = step(st, trainer.device_batch(make_batch(
            DataConfig(**DATA), i), "cpu"))
        hist.append({k: float(v) for k, v in m.items()})
    return st, hist


_REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core.domains import MemoryDomain
from repro.core.hbm import VCU128
from repro.launch.mesh import make_serve_mesh
from repro.models.base import get_arch, init_params
from repro.serving.engine import ServeConfig
from repro.serving.scheduler import ContinuousBatchingScheduler, Request
from repro.training.undervolt import UndervoltPlan

spec = json.loads(sys.argv[1])
jb = get_arch("llama3.2-3b")
cfg = dataclasses.replace(jb.reduced, dtype=jnp.float32)
params = init_params(jb.module.param_specs(cfg), jax.random.PRNGKey(0))
plan = UndervoltPlan(
    domains={"kv": MemoryDomain("kv", spec["v"], tuple(range(32)))},
    policy={"kv_cache": "kv"}, geometry=VCU128)
gov = plan.make_governor("kv", mode="rate", tolerable_rate=1e-3,
                         v_lo=spec["v_lo"])
sc = ServeConfig(max_len=32, max_new_tokens=4, undervolt=plan, governor=gov,
                 kv_injection="read", kv_method="word")
s = ContinuousBatchingScheduler(
    jb, cfg, params, sc, num_slots=4, num_pages=16, page_slots=8,
    mesh=make_serve_mesh(2), shard_setpoints=spec["setpoints"])
for rid, toks, n in spec["reqs"]:
    s.submit(Request(rid=rid, tokens=np.asarray(toks, np.int32),
                     max_new_tokens=n))
res = s.run()

# the (1, 2) and (2, 1) shard_map train steps, from the ranks' init
from repro.launch.mesh import make_mesh_auto
from repro.models.base import spec_avals
from repro.models.dist import DistContext
from repro.optim.adamw import AdamWConfig
from repro.training import trainer
data = dict(np.load(sys.argv[2]))
lb = get_arch("deepseek-v2-lite-16b")
lcfg = dataclasses.replace(lb.reduced, dtype=jnp.float32)
tc = trainer.TrainConfig(adamw=AdamWConfig(**spec["adamw"]))
train = {}
for shape in ((1, 2), (2, 1)):
    mesh = make_mesh_auto(shape, ("data", "model"))
    dist = DistContext(mesh=mesh, batch_axes=("data",), model_axis="model")
    state = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(data["state" + jax.tree_util.keystr(p)]),
        spec_avals(trainer.state_specs(lb, lcfg, tc)))
    step = jax.jit(trainer.make_train_step(lb, lcfg, tc, dist))
    tag = "%d%d" % shape
    for i in range(spec["steps"]):
        with mesh:
            state, m = step(state, {"tokens": jnp.asarray(data[f"tokens{i}"])})
        train[f"loss{tag}_{i}"] = np.asarray(m["loss"])
    for p, v in jax.tree_util.tree_flatten_with_path(state)[0]:
        train[tag + jax.tree_util.keystr(p)] = np.asarray(v)
np.savez(sys.argv[3], **train)
print(json.dumps({
    "results": {str(r): dict(tokens=np.asarray(v.tokens).tolist(),
                             shard=int(v.shard),
                             page_ids=np.asarray(v.page_ids).tolist(),
                             voltage=float(v.voltage))
                for r, v in res.items()},
    "shards": [{k: (float(v) if isinstance(v, (float, np.floating)) else v)
                for k, v in row.items()} for row in s.stats["shards"]]}))
"""


# the reference example's sweep at one voltage, on reduced float32 gemma3
_RESILIENT_SCRIPT = r"""
import dataclasses, importlib.util, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.models.base import get_arch, init_params
from repro.serving.engine import ServeConfig, generate
spec = importlib.util.spec_from_file_location("example", sys.argv[1])
ex = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ex)
jb = get_arch("gemma3-4b")
cfg = dataclasses.replace(jb.reduced, dtype=jnp.float32)
params = init_params(jb.module.param_specs(cfg), jax.random.PRNGKey(0))
prompts = jax.random.randint(jax.random.PRNGKey(1), (4, 12), 0, cfg.vocab)
toks = [np.asarray(generate(jb, cfg, params, {"tokens": prompts}, ServeConfig(
    max_len=64, max_new_tokens=16,
    undervolt=ex.plan_at(v) if v < 1.2 else None))) for v in (1.20, 0.86)]
np.savez(sys.argv[2], prompts=np.asarray(prompts), **{
    jax.tree_util.keystr(p): np.asarray(v)
    for p, v in jax.tree_util.tree_flatten_with_path(params)[0]})
print(json.dumps({"agreement": float((toks[1] == toks[0]).mean())}))
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank run of the module in one launch, beside the reference's
    2-shard scheduler; returns the ranks' results, the reference's, the
    directory and the logical (1, 2) run's state and metrics."""
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    bundle, cfg = _lite()
    init = trainer.init_state(bundle, cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    np.savez(tmp / "ref_train_in.npz", **{
        "state" + pytree.keystr(p): t.detach().numpy()
        for p, t in pytree.flatten_with_path(init)}, **{
        f"tokens{i}": make_batch(DataConfig(**DATA), i)["tokens"]
        for i in range(TRAIN_STEPS)})
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, json.dumps(REF_SPEC),
         str(tmp / "ref_train_in.npz"), str(tmp / "ref_train_out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    resilient = subprocess.Popen(
        [sys.executable, "-c", _RESILIENT_SCRIPT,
         str(ROOT / "examples" / "resilient_inference.py"),
         str(tmp / "gemma_init.npz")],
        env=dict(env, XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                 "intra_op_parallelism_threads=1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # serve_many's parent process, which starts its own 2 ranks
    fleet = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.serve_many",
         "--devices", "2", "--device", "cpu"],
        env=dict(os.environ, OMP_NUM_THREADS="1",
                 PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = (ref, resilient, fleet)
    try:
        # the reference's float32 init, for the rank fleet beside it
        jb = jget_arch("llama3.2-3b")
        jp = jinit_params(jb.module.param_specs(dataclasses.replace(
            jb.reduced, dtype=jnp.float32)), jax.random.PRNGKey(0))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
        np.savez(tmp / "ref_params.npz", **{
            pytree.keystr(p): t.numpy() for p, t in
            pytree.flatten_with_path(tp)})
        # a logical (1, 2) checkpoint for the ranks to restore
        logical, hist = _logical_train((1, 2), _train_plan(), 2)
        ckpt.save(str(tmp / "logical_ckpt"), TRAIN_STEPS, logical)
        runs = [dict(kind="psum", shape=[3, 5], seed=1)]
        runs += [_fleet_run(n, c, {"seed": 0, "on_host": True})
                 for n, c in FLEETS.items()]
        runs.append(_fleet_run(
            "reference", dict(plan=_kv_plan(REF_SPEC["v"]),
                              setpoints=REF_SPEC["setpoints"],
                              governor=dict(domain="kv", mode="rate",
                                            tolerable_rate=1e-3,
                                            v_lo=REF_SPEC["v_lo"]),
                              serve=dict(kv_injection="read",
                                         kv_method="word")),
            {"npz": str(tmp / "ref_params.npz")}, REQS[:4],
            overrides={"dtype": "float32"}))
        runs += [
            _train_run("model", (1, 2), plan=rankwork.plan_spec(_train_plan()),
                       microbatches=2, checkpoint=str(tmp / "rank_ckpt")),
            _train_run("model_plain", (1, 2), adamw=REF_ADAMW),
            _train_run("data_plain", (2, 1), adamw=REF_ADAMW),
            _train_run("data", (2, 1)),
            _train_run("restored", (1, 2), steps=0,
                       init={"ckpt": str(tmp / "logical_ckpt")}),
        ]
        (tmp / "spec.json").write_text(json.dumps(
            {"device": "cpu", "runs": runs}))
        ranks.launch("repro_torch.launch.rankwork", 2,
                     ["--spec", tmp / "spec.json", "--out", tmp / "out",
                      "--threads", "1"], timeout_s=RANK_TIMEOUT_S)
        launcher = ranks.launch(
            "repro_torch.launch.train", 2,
            LAUNCH_ARGS + ["--mesh", "1,2", "--ckpt-dir", tmp / "launch_ck"],
            timeout_s=RANK_TIMEOUT_S, env=dict(os.environ,
                                               OMP_NUM_THREADS="1"))
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    got = [json.loads((tmp / "out" / f"rank{r}.json").read_text())
           for r in range(2)]
    last = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs[:2]]
    with np.load(tmp / "ref_train_out.npz") as z:
        ref_train = {k: z[k] for k in z.files}
    return dict(ranks=got, ref=last[0], resilient=last[1], tmp=tmp,
                ref_train=ref_train,
                logical=logical, hist=hist, launcher=launcher,
                serve_many=outs[2][0])


def _npz_state(path, like):
    """A state shaped like ``like`` from a rank's npz dump."""
    with np.load(path) as z:
        out = pytree.tree_map(lambda t: t, like)
        for p, t in pytree.flatten_with_path(like):
            pytree.set_path(out, p, torch.from_numpy(
                np.array(z[pytree.keystr(p)])).to(t.dtype).reshape(t.shape))
    return out


def _bits_equal(a, b):
    """Same leaves, dtypes and raw bytes (NaNs included)."""
    def raw(t):
        return t.detach().contiguous().reshape(-1).view(torch.uint8)
    la, lb = pytree.leaves(a), pytree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(raw(x), raw(y)) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# the rank layer in process
# ---------------------------------------------------------------------------


def test_layout_and_backend_rules():
    """The data plane is nccl only when every rank has a card of its own;
    a rank mesh needs world == its size; rank rows split each microbatch
    by data rank; a serve mesh spreads its shards over the ranks."""
    assert ranks.data_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert ranks.data_backend(["cuda:0", "cuda:0"]) == "gloo"
    assert ranks.data_backend(["cpu", "cpu"]) == "gloo"
    assert ranks.rank_devices(2, "cpu") == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="cuda:N"):
        ranks.init_ranks(addr="127.0.0.1", port=1, world=2, rank=0,
                         devices=["cuda", "cuda"])
    np.testing.assert_array_equal(rank_rows(8, 1, 2, 2), [2, 3, 6, 7])
    np.testing.assert_array_equal(rank_rows(4, 0, 1, 1), [0, 1, 2, 3])

    class _G:   # a stand-in group: what make_serve_mesh reads
        world, rank = 2, 1
        devices = (torch.device("cpu"), torch.device("cpu"))
    mesh = make_serve_mesh(4, group=_G())
    assert mesh.owners == (0, 0, 1, 1) and mesh.shape == {"serve": 4}
    with pytest.raises(ShardLayoutError, match="same number of shards"):
        make_serve_mesh(3, group=_G())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_rank_placement_corrupts_the_logical_words(dtype):
    """Each model rank's expert rows, injected through its cut of the
    global placement (one arena pass, ECC at 0.86 V), equal the logical
    injection's rows on bits; the ranks' counts add up to the logical
    counts (replicated leaves counted on model rank 0 only)."""
    bundle, cfg = _lite()
    cfg = dataclasses.replace(cfg, dtype=dtype)
    plan = _train_plan()
    pspecs = bundle.module.param_specs(cfg)
    placement = plan.place({"params": spec_avals(pspecs)})["params"]
    tree = pytree.tree_map(lambda t: t.detach(), init_params(
        pspecs, torch.Generator().manual_seed(3), device="cpu"))
    dims = {k[len("['params']"):]: d for k, d in
            state_expert_dims(pspecs).items() if k.startswith("['params']")}
    want, bad, corr = inject_groups({"params": tree}, {"params": placement},
                                    plan.fault_map(), voltage=0.86,
                                    with_corrected=True)
    total = [0, 0]
    for j in range(2):
        rp = rank_placement(placement, pspecs, j, 2)
        got, b, c = inject_groups(
            {"params": split_state(tree, dims, j, 2)}, {"params": rp},
            plan.fault_map(), voltage=0.86, with_corrected=True)
        assert _bits_equal(got["params"],
                           split_state(want["params"], dims, j, 2))
        total[0] += int(b)
        total[1] += int(c)
    assert total == [int(bad), int(corr)] and total[1] > 0


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def test_psum_model_equals_logical_sum_on_bits(world):
    """Forward: every rank's psum == the logical mesh's ordered sum of the
    two parts; backward: each part gets the cotangent; model_grad_sum
    hands x the rank-order sum of the ranks' cotangents."""
    got = [g["runs"]["run0"] for g in world["ranks"]]
    gen = lambda s: torch.randn((3, 5), generator=torch.Generator(  # noqa
    ).manual_seed(s))
    parts = [gen(1 + j).requires_grad_(True) for j in range(2)]
    y = D.psum_model(parts)
    grads = torch.autograd.grad((y * gen(101)).sum(), parts)
    for j in range(2):
        assert torch.equal(torch.tensor(got[j]["y"]), y.detach())
        assert torch.equal(torch.tensor(got[j]["grad_part"]), grads[j])
        assert torch.equal(torch.tensor(got[j]["grad_x"]),
                           gen(301) + gen(302))


# ---------------------------------------------------------------------------
# the paged fleet over ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(FLEETS))
def test_rank_fleet_equals_logical_shards_on_bits(world, name):
    """The 2-rank fleet == the logical 2-shard scheduler: every request's
    tokens, shard, page ids and admission voltage, the per-shard stats,
    the pricing voltages; both ranks hold the same results; one decode
    trace a rank; every request replayed alone on its rank."""
    c = FLEETS[name]
    params = init_params(TB.module.param_specs(CFG),
                         torch.Generator().manual_seed(0), device="cpu")
    gov = None
    if c.get("governor"):
        g = dict(c["governor"])
        gov = c["plan"].make_governor(g.pop("domain"), **g)
    sc = ServeConfig(max_len=32, max_new_tokens=4, undervolt=c["plan"],
                     governor=gov, **c["serve"])
    s = ContinuousBatchingScheduler(
        TB, CFG, params, sc, device="cpu",
        mesh=make_serve_mesh(2, devices=["cpu"] * 2),
        shard_setpoints=c.get("setpoints"), **SCHED)
    for rid, toks, n, tier, seed in REQS:
        s.submit(Request(rid=rid, tokens=np.asarray(toks, np.int32),
                         max_new_tokens=n, tier=tier,
                         generator=torch.Generator().manual_seed(seed)))
    res = s.run()
    r0, r1 = (g["runs"][name] for g in world["ranks"])
    assert r0["results"] == r1["results"]
    assert set(r0["results"]) == set(res)
    for rid, want in res.items():
        got = r0["results"][rid]
        assert got["tokens"] == want.tokens.tolist(), rid
        assert got["shard"] == want.shard, rid
        assert got["page_ids"] == want.page_ids.tolist(), rid
        assert np.float32(got["voltage"]) == np.float32(want.voltage), rid
    assert {r["shard"] for r in r0["results"].values()} == {0, 1}
    for row, want in zip(r0["shards"], s.stats["shards"]):
        for key in ("shard", "active", "free_pages", "weak_pages",
                    "shared_pages", "setpoint", "map_seed"):
            assert row[key] == want[key], key
        assert np.float32(row["voltage"]) == np.float32(want["voltage"])
    assert r0["pricing"] == [float(v) for v in s.pricing_voltages]
    assert r0["steps"] == r1["steps"] == s.steps
    assert r0["decode_traces"] == r1["decode_traces"] == 1
    assert (r0["local_shards"], r1["local_shards"]) == ([0], [1])
    assert len(r0["exchange_ms"]) == s.steps
    if gov is None:
        by_shard = {k: sorted(rid for rid, r in res.items() if r.shard == k)
                    for k in (0, 1)}
        assert sorted(r0["replayed"]) == by_shard[0]
        assert sorted(r1["replayed"]) == by_shard[1]
    else:
        v = [row["voltage"] for row in r0["shards"]]
        assert v[0] > v[1]


def test_rank_fleet_equals_reference_scheduler(world):
    """On the reference's float32 init, governed with setpoints (1e-9,
    1e-4): the rank fleet's tokens, shards, page ids, admission and shard
    voltages equal the reference's 2-shard scheduler's."""
    got = world["ranks"][0]["runs"]["reference"]
    ref = world["ref"]
    assert set(ref["results"]) == set(got["results"])
    for rid, want in ref["results"].items():
        g = got["results"][rid]
        assert g["tokens"] == want["tokens"], rid
        assert g["shard"] == want["shard"], rid
        assert g["page_ids"] == want["page_ids"], rid
        assert np.float32(g["voltage"]) == np.float32(want["voltage"]), rid
    for row, want in zip(got["shards"], ref["shards"]):
        for key in ("shard", "active", "free_pages", "weak_pages",
                    "shared_pages", "setpoint", "map_seed"):
            assert row[key] == want[key], key
        assert np.float32(row["voltage"]) == np.float32(want["voltage"])


# ---------------------------------------------------------------------------
# MoE training over ranks
# ---------------------------------------------------------------------------


def test_model_ranks_equal_logical_mesh_on_bits(world):
    """(1, 2): reduced float32 deepseek-v2-lite, ECC plan at 0.88 V, 2
    microbatches, 2 steps: each rank's loss, fault counts, parameters and
    AdamW moments (its experts' rows) equal the logical (1, 2) mesh's on
    bits; each rank's K2 calls of step 0 == plain."""
    tmp, logical, hist = world["tmp"], world["logical"], world["hist"]
    bundle, cfg = _lite()
    dims = state_expert_dims(bundle.module.param_specs(cfg))
    for r, g in enumerate(world["ranks"]):
        run = g["runs"]["model"]
        assert run["loss"] == [h["loss"] for h in hist]
        assert run["corrected_faults"] == [h["corrected_faults"]
                                           for h in hist]
        assert run["uncorrectable_faults"] == [h["uncorrectable_faults"]
                                               for h in hist]
        assert min(run["corrected_faults"]) > 0
        assert run["arena_checked"] >= 1
        want = split_state(logical, dims, r, 2)
        assert _bits_equal(_npz_state(tmp / "out" / f"rank{r}_model.npz",
                                      want), want)


def test_data_ranks_agree_with_logical_mesh(world):
    """(2, 1): each data rank trains its rows of every global batch; the
    losses agree with the logical (2, 1) mesh within 1e-6 relative, the
    state within 1e-5 + 1e-5 |logical|, and both ranks hold one state."""
    tmp = world["tmp"]
    logical, hist = _logical_train((2, 1))
    states = []
    for r, g in enumerate(world["ranks"]):
        run = g["runs"]["data"]
        for a, h in zip(run["loss"], hist):
            assert abs(a - h["loss"]) <= LOSS_RTOL * abs(h["loss"])
        states.append(_npz_state(tmp / "out" / f"rank{r}_data.npz", logical))
    assert _bits_equal(states[0], states[1])
    for a, b in zip(pytree.leaves(states[0]), pytree.leaves(logical)):
        b = b.detach().float()
        assert torch.all((a.float() - b).abs() <= PARAM_TOL
                         + PARAM_TOL * b.abs())


@pytest.mark.parametrize("mesh,run", [((1, 2), "model_plain"),
                                      ((2, 1), "data_plain")],
                         ids=["model-ranks", "data-ranks"])
def test_rank_training_matches_reference_shard_map(world, mesh, run):
    """From one init, each rank's 2 steps on a (1, 2) and a (2, 1) rank
    mesh (reduced float32 deepseek-v2-lite, AdamW at ``REF_ADAMW``, no
    plan) against the reference's ``shard_map`` train step on the same
    mesh shape over two forced host devices: losses within 1e-5 relative,
    each rank's AdamW moments (its experts' rows) within 1e-5 + 1e-5
    |ref|, and each parameter leaf's update from the init within
    ``REF_UPDATE_GAP`` relative L2 of the reference's."""
    ref, tmp = world["ref_train"], world["tmp"]
    tag = "%d%d" % mesh
    bundle, cfg = _lite()
    dims = state_expert_dims(bundle.module.param_specs(cfg))
    template = trainer.init_state(bundle, cfg,
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    want = pytree.tree_map(lambda t: t, template)
    for p, t in pytree.flatten_with_path(template):
        pytree.set_path(want, p, torch.from_numpy(np.array(
            ref[tag + pytree.keystr(p)])).to(t.dtype).reshape(t.shape))
    for r, g in enumerate(world["ranks"]):
        losses = g["runs"][run]["loss"]
        assert len(losses) == TRAIN_STEPS
        for i, a in enumerate(losses):
            b = float(ref[f"loss{tag}_{i}"])
            assert abs(a - b) <= REF_LOSS_RTOL * abs(b), (r, i, a, b)
        mine = split_state(want, dims, r % mesh[1], mesh[1])
        start = split_state(template, dims, r % mesh[1], mesh[1])
        got = _npz_state(tmp / "out" / f"rank{r}_{run}.npz", mine)
        for (p, a), b, a0 in zip(pytree.flatten_with_path(got),
                                 pytree.leaves(mine), pytree.leaves(start)):
            key = pytree.keystr(p)
            a, b, a0 = a.float(), b.detach().float(), a0.detach().float()
            if key.startswith("['params']"):
                gap = (a - b).norm() / (b - a0).norm()
                assert float(gap) <= REF_UPDATE_GAP, (r, key, float(gap))
            else:
                excess = (a - b).abs() - REF_TOL * b.abs()
                assert float(excess.max()) <= REF_TOL, (r, key)


def test_checkpoint_written_on_ranks_restores_on_logical_mesh(world):
    """The ranks' checkpoint (the logical layout, rank 0 after a barrier)
    restores on the logical mesh to the join of the ranks' states, and to
    the logical run's state, on bits."""
    tmp, logical = world["tmp"], world["logical"]
    bundle, cfg = _lite()
    dims = state_expert_dims(bundle.module.param_specs(cfg))
    template = trainer.init_state(bundle, cfg,
                                  torch.Generator().manual_seed(1),
                                  device="cpu")
    restored, meta = ckpt.restore(str(tmp / "rank_ckpt"), template)
    assert meta["step"] == TRAIN_STEPS
    joined = join_states([_npz_state(
        tmp / "out" / f"rank{r}_model.npz",
        split_state(logical, dims, r, 2)) for r in range(2)], dims)
    assert _bits_equal(restored, joined)
    assert _bits_equal(restored, logical)


def test_logical_checkpoint_restores_on_ranks(world):
    """A logical mesh's checkpoint restores on each rank to its rows of
    the logical state, on bits."""
    tmp, logical = world["tmp"], world["logical"]
    bundle, cfg = _lite()
    dims = state_expert_dims(bundle.module.param_specs(cfg))
    for r in range(2):
        want = split_state(logical, dims, r, 2)
        assert _bits_equal(_npz_state(
            tmp / "out" / f"rank{r}_restored.npz", want), want)


def test_launcher_over_ranks(world, capsys):
    """``launch.train --mesh 1,2`` over 2 ranks: rank 0 prints the
    reference's lines (the other rank none), its losses within 1e-4
    relative of the undistributed run's (a model-parallel sum is another
    rounding), and its checkpoint is the logical layout."""
    from repro_torch.launch import train as launch_train
    step_re = re.compile(r"^step +(\d+)  loss ([0-9.]+)", re.M)
    rank0, rank1 = world["launcher"]
    assert "[undervolt] blended HBM savings" in rank0
    assert "[ckpt] final checkpoint at step 3" in rank0
    assert not step_re.search(rank1) and "[ckpt]" not in rank1
    launch_train.main(LAUNCH_ARGS)
    want = step_re.findall(capsys.readouterr().out)
    got = step_re.findall(rank0)
    assert [s for s, _ in got] == [s for s, _ in want] == ["0", "2"]
    for (_, a), (_, b) in zip(got, want):
        assert abs(float(a) - float(b)) <= 1e-4 * float(b)
    bundle = get_arch(LITE)
    template = trainer.init_state(bundle, bundle.reduced,
                                  torch.Generator().manual_seed(1),
                                  device="cpu")
    state, meta = ckpt.restore(str(world["tmp"] / "launch_ck"), template)
    assert meta["step"] == 3 and int(state["opt"]["step"]) == 3


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------


def test_tradeoff_explorer_prints_the_reference_text():
    """Frontier, operating point and governor walk: the port's text ==
    the reference example's."""
    for argv in ([],):
        outs = []
        for run in (lambda: tradeoff_explorer.main(argv),
                    lambda: runpy.run_path(
                        str(ROOT / "examples" / "tradeoff_explorer.py"),
                        run_name="__main__")):
            buf = io.StringIO()
            old = sys.argv
            sys.argv = ["tradeoff_explorer.py", *argv]
            try:
                with contextlib.redirect_stdout(buf):
                    run()
            finally:
                sys.argv = old
            outs.append(buf.getvalue())
        assert outs[0] == outs[1] and "governor walk" in outs[0]


def test_resilient_inference_agreement_equals_reference(world):
    """At 0.86 V on reduced float32 gemma3-4b (the reference's init and
    prompts), the port example's greedy agreement with nominal equals the
    reference example's figure (run beside the ranks)."""
    tb = get_arch("gemma3-4b")
    cfg = dataclasses.replace(tb.reduced, dtype=torch.float32)
    params = init_params(tb.module.param_specs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    with np.load(world["tmp"] / "gemma_init.npz") as z:
        prompts = torch.from_numpy(np.array(z["prompts"]))
        for p, t in pytree.flatten_with_path(params):
            pytree.set_path(params, p, torch.from_numpy(
                np.array(z[pytree.keystr(p)])))
    rows = resilient_inference.sweep(tb, cfg, params, prompts,
                                     (1.20, 0.86), "cpu")
    assert rows[0][2] == 1.0
    assert rows[1][2] == world["resilient"]["agreement"]


def test_serve_many_over_ranks_equals_logical_shards(world, capsys):
    """``serve_many --devices 2`` over 2 CPU ranks (run beside the other
    ranks) reports the same requests (shard, voltage, weak and shared
    pages, TTFT, tokens) and shard lines as the same 2 shards served
    logically in one process."""
    keep = re.compile(r"^(req\d|shard \d|fleet: power)")
    serve_many.main(["--devices", "2", "--device", "cpu", "--logical"])
    lines = [[ln for ln in out.splitlines() if keep.match(ln)]
             for out in (world["serve_many"], capsys.readouterr().out)]
    assert "control-plane exchanges" in world["serve_many"]
    assert len(lines[0]) == 16 + 2 + 1
    assert lines[0] == lines[1]
