"""Expert-parallel MoE training on a logical (data, model) mesh held against
the reference's ``shard_map`` run.

The reference runs in one module-scoped subprocess with four forced host
devices (``--xla_force_host_platform_device_count=4``) on reduced
float32 deepseek-v2-lite (8 experts, top 2) over a (data 2, model 2)
mesh; both packages start from one numpy-seeded state.  Against it the
port on a logical (2, 2) CPU mesh: ``moe_ffn`` outputs and aux loss
within 1e-5 + 1e-5 |ref| (the kept (token, choice) pairs of every data
and model shard equal the reference dispatch's) at capacity factor 2.0
and 0.5; ``forward_train``'s loss within 1e-5 relative and every
gradient leaf within 1e-4 + 1e-4 |ref| at 0.5; two AdamW steps of
``make_train_step(..., dist)``: losses within 1e-5 relative, parameters
and moments within 1e-5 + 1e-5 |ref|; ``prefill``'s logits within
1e-5 + 1e-5 |ref|.  In process: a (1, 1) mesh equals ``dist=None`` on
bits, distinct devices with no process group raise ``ShardLayoutError``,
the launcher's resumed run equals its uninterrupted run on bits, and the
elastic example's crash below V_critical, restore and resume.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import pytree
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.examples import elastic_train
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import ShardLayoutError, make_mesh_auto
from repro_torch.models import dist as D
from repro_torch.models import moe
from repro_torch.models.base import ParamSpec, get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import trainer

LITE = "deepseek-v2-lite-16b"
ADAMW = dict(lr=3e-3, warmup_steps=10, total_steps=200)
Y_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-5
BATCH, SEQ, MAX_LEN = 4, 12, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(f32=True, **kw):
    cfg = get_arch(LITE).reduced
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return dataclasses.replace(cfg, **kw)


def _mesh(shape=(2, 2)):
    return make_mesh_auto(shape, ("data", "model"), device="cpu")


def _dist(shape=(2, 2)):
    return D.DistContext(mesh=_mesh(shape))


@functools.lru_cache(maxsize=None)
def _np_state(f32=True):
    """The shared initial train state, numpy leaves by keystr: the init
    rule's normal draws (std ``scale / sqrt(fan_in)``) from a numpy seed."""
    cfg = _cfg(f32)
    specs = trainer.state_specs(get_arch(LITE), cfg)
    rng = np.random.RandomState(0)
    out = {}
    for path, s in pytree.flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, ParamSpec)):
        dt = torch.empty((), dtype=s.dtype).numpy().dtype \
            if s.dtype != torch.bfloat16 else np.float32
        if s.init == "normal":
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            v = rng.standard_normal(s.shape) * (s.scale / np.sqrt(fan_in))
        elif s.init == "const":
            v = np.full(s.shape, s.scale)
        else:
            v = np.full(s.shape, 1.0 if s.init == "ones" else 0.0)
        out[pytree.keystr(path)] = np.asarray(v, dtype=dt)
    return out


def _state(f32=True):
    """A fresh port train state from :func:`_np_state`."""
    cfg = _cfg(f32)
    st = trainer.init_state(get_arch(LITE), cfg,
                            torch.Generator().manual_seed(0), device="cpu")
    arrays = _np_state(f32)
    for path, leaf in pytree.flatten_with_path(st):
        t = torch.from_numpy(arrays[pytree.keystr(path)].copy()).to(
            leaf.dtype)
        if leaf.requires_grad:
            t.requires_grad_(True)
        pytree.set_path(st, path, t)
    return st


def _layer(state):
    return {k: v[0].detach() for k, v in
            state["params"]["stack"]["periods"]["s0_moe"].items()}


def _x():
    return np.random.RandomState(4).standard_normal(
        (BATCH, SEQ, _cfg().d_model)).astype(np.float32)


def _batch(step):
    dc = DataConfig(vocab=_cfg().vocab, seq_len=SEQ, global_batch=BATCH,
                    seed=3)
    return make_batch(dc, step)


_REF_SCRIPT = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh_auto
from repro.models import moe
from repro.models.base import get_arch, spec_avals
from repro.models.dist import DistContext
from repro.optim.adamw import AdamWConfig
from repro.training import trainer

inp, out_path = sys.argv[1], sys.argv[2]
data = dict(np.load(inp))
ADAMW = dict(lr=3e-3, warmup_steps=10, total_steps=200)
jb = get_arch("deepseek-v2-lite-16b")
cfg = dataclasses.replace(jb.reduced, dtype=jnp.float32)
mesh = make_mesh_auto((2, 2), ("data", "model"))
dist = DistContext(mesh=mesh, batch_axes=("data",), model_axis="model")
tc = trainer.TrainConfig(adamw=AdamWConfig(**ADAMW))
state = jax.tree_util.tree_map_with_path(
    lambda p, a: jnp.asarray(data["state" + jax.tree_util.keystr(p)]),
    spec_avals(trainer.state_specs(jb, cfg, tc)))
batches = [{"tokens": jnp.asarray(data[f"tokens{i}"])} for i in range(2)]
res = {}
layer = jax.tree.map(lambda v: v[0],
                     state["params"]["stack"]["periods"]["s0_moe"])
for cf in (2.0, 0.5):
    c = dataclasses.replace(cfg, capacity_factor=cf)
    with mesh:
        y, aux = jax.jit(lambda p, x: moe.moe_ffn(c, p, x, dist))(
            layer, jnp.asarray(data["x"]))
    res[f"y{cf}"], res[f"aux{cf}"] = np.asarray(y), np.asarray(aux)
c = dataclasses.replace(cfg, capacity_factor=0.5)
with mesh:
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: jb.module.forward_train(p, b, c, dist), has_aux=True))(
        state["params"], batches[0])
res["loss"], res["xent"], res["aux"] = (np.asarray(loss),
                                        np.asarray(m["xent"]),
                                        np.asarray(m["router_aux"]))
for p, v in jax.tree_util.tree_flatten_with_path(g)[0]:
    res["grad" + jax.tree_util.keystr(p)] = np.asarray(v)
with mesh:
    lg, _ = jax.jit(lambda p, b: jb.module.prefill(p, b, cfg, 16, dist))(
        state["params"], batches[0])
res["prefill"] = np.asarray(lg)
step = jax.jit(trainer.make_train_step(jb, cfg, tc, dist))
for i in range(2):
    with mesh:
        state, m = step(state, batches[i])
    res[f"step_loss{i}"] = np.asarray(m["loss"])
for p, v in jax.tree_util.tree_flatten_with_path(state)[0]:
    res["after" + jax.tree_util.keystr(p)] = np.asarray(v)
np.savez(out_path, **res)
"""


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """The reference's (2, 2) shard_map run, started with the module's
    first test and read on first use, so the in-process tests run beside
    it."""
    d = tmp_path_factory.mktemp("dist_ref")
    inp, out = d / "in.npz", d / "out.npz"
    arrays = {"state" + k: v for k, v in _np_state().items()}
    arrays.update(x=_x(), tokens0=_batch(0)["tokens"],
                  tokens1=_batch(1)["tokens"])
    np.savez(inp, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(inp), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    result = {}

    def get():
        if not result:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-4000:]
            result.update(np.load(out))
        return result

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _close(got, want, tol, what):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    excess = np.abs(got - want) - tol * np.abs(want)
    assert excess.max() <= tol, (what, float(excess.max()))


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


# -- in process --------------------------------------------------------------


def test_unit_mesh_equals_no_dist_on_bits():
    """bf16 reduced deepseek-v2-lite: on a (1, 1) mesh moe_ffn (both
    capacities), forward_train's loss and gradients, two train steps and
    prefill equal dist=None on bits."""
    one = _dist((1, 1))
    st_a, st_b = _state(f32=False), _state(f32=False)
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    for cf in (2.0, 0.5):
        cfg = _cfg(False, capacity_factor=cf)
        ya, aa = moe.moe_ffn(cfg, _layer(st_a), x)
        yb, ab = moe.moe_ffn(cfg, _layer(st_a), x, dist=one)
        assert torch.equal(ya, yb) and torch.equal(aa, ab)
    cfg = _cfg(False, capacity_factor=0.5)
    b0 = trainer.device_batch(_batch(0), "cpu")
    la, _ = moe.forward_train(st_a["params"], b0, cfg)
    lb, _ = moe.forward_train(st_b["params"], b0, cfg, one)
    assert torch.equal(la, lb)
    ga = torch.autograd.grad(la, pytree.leaves(st_a["params"]))
    gb = torch.autograd.grad(lb, pytree.leaves(st_b["params"]))
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
    tc = trainer.TrainConfig(adamw=AdamWConfig(**ADAMW))
    sa = trainer.make_train_step(get_arch(LITE), cfg, tc)
    sb = trainer.make_train_step(get_arch(LITE), cfg, tc, one)
    for i in range(2):
        b = trainer.device_batch(_batch(i), "cpu")
        st_a, ma = sa(st_a, b)
        st_b, mb = sb(st_b, b)
        assert torch.equal(ma["loss"], mb["loss"])
    for a, b in zip(pytree.leaves(st_a), pytree.leaves(st_b)):
        assert torch.equal(a, b)
    pa, _ = moe.prefill(st_a["params"], b0, cfg, MAX_LEN)
    pb, _ = moe.prefill(st_a["params"], b0, cfg, MAX_LEN, one)
    assert torch.equal(pa, pb)


def test_distinct_devices_raise_and_dist_context():
    """Distinct devices with no process group spanning them still raise
    (a rank mesh, launch.mesh.make_rank_mesh, spans them)."""
    with pytest.raises(ShardLayoutError,
                       match="distinct devices .* no process group spans"):
        make_mesh_auto((2, 1), ("data", "model"), devices=["cuda:0", "cuda:1"])
    with pytest.raises(ShardLayoutError):
        make_mesh_auto((1, 2), ("data", "model"), devices=["cpu", "meta"])
    dist = _dist((2, 2))
    assert (dist.data_size, dist.model_size) == (2, 2)
    assert dist.activation_sharding((8, 16, 4, 32)) == ("data", None, None,
                                                        None)
    assert D.current() is None
    with D.use(dist):
        assert D.current() is dist
    assert D.ensure(dist) is dist and D.ensure(None).model_size == 1
    with pytest.raises(ValueError, match="do not split"):
        moe.moe_ffn(_cfg(), _layer(_state()), torch.zeros(3, 2, 64),
                    dist=dist)


def test_launcher_resume_equals_uninterrupted(tmp_path, capsys):
    """``launch.train.main``: 3 steps, then --resume to 6, equals 6 steps
    in one run on bits (the warmup schedule does not read --steps)."""
    common = ["--arch", "llama3.2-3b", "--device", "cpu", "--seq", "32",
              "--batch", "4", "--microbatches", "2",
              "--grad-compression", "int8_ef"]
    whole = launch_train.main(common + ["--steps", "6", "--ckpt-dir",
                                        str(tmp_path / "a")])
    launch_train.main(common + ["--steps", "3", "--ckpt-dir",
                                str(tmp_path / "b")])
    resumed = launch_train.main(common + ["--steps", "6", "--ckpt-dir",
                                          str(tmp_path / "b"), "--resume"])
    out = capsys.readouterr().out
    assert "[resume] restored step 3" in out
    assert "[undervolt] blended HBM savings" in out
    assert out.count("[ckpt] final checkpoint at step 6") == 2
    assert int(resumed["opt"]["step"]) == 6
    for a, b in zip(pytree.leaves(whole), pytree.leaves(resumed)):
        assert torch.equal(a.detach(), b.detach())
    on_disk, _ = ckpt.restore(str(tmp_path / "a"), whole)
    for a, b in zip(pytree.leaves(whole), pytree.leaves(on_disk)):
        assert torch.equal(a.detach(), b.detach())


def test_elastic_example_crash_restore_resume(capsys):
    restored, state, crashed = elastic_train.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert crashed and "CRASH detected" in out
    assert restored == 10 and int(state["opt"]["step"]) == 15
    assert "resumed to step 15" in out
    assert all(torch.isfinite(t.detach().float()).all()
               for t in pytree.leaves(state["params"]))


# -- against the reference's shard_map run ----------------------------------


def _kept_reference(top_e, n_data, n_model, n_experts, cap):
    """The reference's dispatch (``moe_ffn``'s ``local_fn`` per data and
    model shard): the kept (token, choice) flat indices of each."""
    b, s, k = top_e.shape
    bl, e_loc = b // n_data, n_experts // n_model
    out = {}
    for i in range(n_data):
        fe = jnp.asarray(top_e[i * bl:(i + 1) * bl]).reshape(-1)
        for j in range(n_model):
            e0 = j * e_loc
            loc = jnp.where((fe >= e0) & (fe < e0 + e_loc), fe - e0, e_loc)
            order = jnp.argsort(loc)
            se = loc[order]
            rank = jnp.arange(fe.shape[0]) - jnp.searchsorted(se, se,
                                                              side="left")
            keep = np.asarray((se < e_loc) & (rank < cap))
            out[i, j] = set(np.asarray(order)[keep].tolist())
    return out


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["no-drops", "drops"])
def test_moe_ffn_matches_reference(reference, cf):
    ref = reference()
    cfg = _cfg(capacity_factor=cf)
    dist = _dist()
    layer = _layer(_state())
    x = torch.from_numpy(_x())
    y, aux = moe.moe_ffn(cfg, layer, x, dist=dist)
    _close(y, ref[f"y{cf}"], Y_TOL, "y")
    assert _rel(aux, ref[f"aux{cf}"]) < LOSS_RTOL
    # the kept pairs of every (data, model) shard
    probs = torch.softmax(x @ layer["w_router"], -1)
    _, top_e = moe._top_k(probs, cfg.top_k)
    t_loc = (BATCH // 2) * SEQ
    cap = moe.capacity(cfg, t_loc, decode=False)
    want = _kept_reference(top_e.numpy(), 2, 2, cfg.n_experts, cap)
    dropped = 0
    for (i, j), kept in want.items():
        te = top_e[i * 2:(i + 1) * 2].reshape(t_loc, cfg.top_k)
        e_loc = cfg.n_experts // 2
        order, slot = moe.dispatch(te, e_loc, cap, j * e_loc)
        got = set(order[slot < e_loc * cap].tolist())
        assert got == kept, (i, j)
        dropped += sum(1 for e in te.reshape(-1).tolist()
                       if j * e_loc <= e < (j + 1) * e_loc) - len(kept)
    assert (dropped > 0) == (cf < 1.0)
    if cf < 1.0:    # the one-shard dispatch is not the reference's here
        y1, _ = moe.moe_ffn(cfg, layer, x)
        assert np.abs(y1.numpy() - ref[f"y{cf}"]).max() > 100 * Y_TOL


def test_forward_train_matches_reference(reference):
    """Capacity 0.5 (drops): loss, xent and router aux, every gradient."""
    ref = reference()
    cfg = _cfg(capacity_factor=0.5)
    st = _state()
    loss, m = moe.forward_train(
        st["params"], trainer.device_batch(_batch(0), "cpu"), cfg, _dist())
    for key, name in (("loss", "loss"), ("xent", "xent"),
                      ("router_aux", "aux")):
        assert _rel(m[key].detach(), ref[name]) < LOSS_RTOL, key
    grads = torch.autograd.grad(loss, pytree.leaves(st["params"]))
    for (path, _), g in zip(pytree.flatten_with_path(st["params"]), grads):
        _close(g, ref["grad" + pytree.keystr(path)], GRAD_TOL,
               pytree.keystr(path))


def test_two_train_steps_match_reference(reference):
    ref = reference()
    cfg = _cfg()
    st = _state()
    step = trainer.make_train_step(get_arch(LITE), cfg, trainer.TrainConfig(
        adamw=AdamWConfig(**ADAMW)), _dist())
    for i in range(2):
        st, m = step(st, trainer.device_batch(_batch(i), "cpu"))
        assert _rel(m["loss"], ref[f"step_loss{i}"]) < LOSS_RTOL, i
    assert int(st["opt"]["step"]) == 2
    for path, leaf in pytree.flatten_with_path(st):
        _close(leaf, ref["after" + pytree.keystr(path)], PARAM_TOL,
               pytree.keystr(path))


def test_prefill_matches_reference(reference):
    ref = reference()
    st = _state()
    logits, _ = moe.prefill(
        st["params"], trainer.device_batch(_batch(0), "cpu"), _cfg(),
        MAX_LEN, _dist())
    assert logits.shape == ref["prefill"].shape == (BATCH, _cfg().vocab)
    _close(logits, ref["prefill"], 1e-5, "prefill")
