"""The port's checkpoints held against the reference's.

Both packages write the same files (``step_<N>.npz`` keyed by keystr,
bf16 as raw 16-bit words under ``<key>@bfloat16``, plus
``step_<N>.json``): a train state the port saved restores into the
reference's template bit for bit, and one the reference saved restores
into the port's.  A crash-and-restore continuation equals the
uninterrupted one on losses and state bits; the async writer keeps the
newest checkpoints.
"""
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt

from repro_torch import convert
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import pytree
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models.base import get_arch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BUNDLE = get_arch("llama3.2-3b")
CFG = BUNDLE.reduced                       # bf16 parameters
TC = trainer.TrainConfig(adamw=AdamWConfig(lr=3e-3, warmup_steps=10,
                                           total_steps=200))


def _state(seed=0):
    return trainer.init_state(BUNDLE, CFG,
                              torch.Generator().manual_seed(seed),
                              device="cpu")


def _numpy_bits(tree):
    """Raw words of every leaf, keyed by keystr (copies: a CPU tensor's
    numpy view would follow the in-place steps)."""
    return {pytree.keystr(p): convert.tensor_to_numpy_bits(t).copy()
            for p, t in pytree.flatten_with_path(tree)}


def _as_reference(tree):
    """The port's tree as numpy arrays in the reference's dtypes."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return convert.tensor_to_numpy_bits(t).view(ml_dtypes.bfloat16)
        return t.detach().numpy().copy()
    return pytree.tree_map(one, tree)


def _run(state, start, steps):
    dc = DataConfig(vocab=CFG.vocab, seq_len=16, global_batch=4, seed=3)
    step = trainer.make_train_step(BUNDLE, CFG, TC)
    losses = []
    for i in range(start, start + steps):
        state, m = step(state, trainer.device_batch(make_batch(dc, i),
                                                    "cpu"))
        losses.append(float(m["loss"]))
    return state, losses


def _clone(state):
    out = pytree.tree_map(lambda t: t.detach().clone(), state)
    for p in pytree.leaves(out["params"]):
        p.requires_grad_(True)
    return out


def test_port_checkpoint_restores_in_reference(tmp_path):
    state, _ = _run(_state(), 0, 2)
    ckpt.save(str(tmp_path), 2, state, {"note": "port"})
    template = jax.tree.map(np.zeros_like, _as_reference(state))
    restored, meta = jckpt.restore(str(tmp_path), template)
    assert meta == {"step": 2, "note": "port"}
    flat = jax.tree_util.tree_flatten_with_path(restored)[0]
    want = _numpy_bits(state)
    assert len(flat) == len(want)
    for path, leaf in flat:
        raw = want[jax.tree_util.keystr(path)]
        leaf = np.asarray(leaf)
        assert leaf.dtype.itemsize == raw.dtype.itemsize
        np.testing.assert_array_equal(leaf.view(raw.dtype), raw)


def test_reference_checkpoint_restores_in_port(tmp_path):
    state, _ = _run(_state(1), 0, 2)
    jckpt.save(str(tmp_path), 7, jax.tree.map(jax.numpy.asarray,
                                              _as_reference(state)))
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored, meta = ckpt.restore(str(tmp_path), _state(2))
    assert meta == {"step": 7}
    assert _numpy_bits(restored).keys() == _numpy_bits(state).keys()
    for k, raw in _numpy_bits(restored).items():
        np.testing.assert_array_equal(raw, _numpy_bits(state)[k], err_msg=k)
    assert restored["opt"]["step"].shape == () and int(
        restored["opt"]["step"]) == 2
    assert all(p.requires_grad and p.is_leaf
               for p in pytree.leaves(restored["params"]))


def test_crash_restore_continuation_bit_exact(tmp_path):
    state, _ = _run(_state(), 0, 5)
    ckpt.save(str(tmp_path), 5, state)
    cont, l_cont = _run(_clone(state), 5, 3)
    restored, meta = ckpt.restore(str(tmp_path), _state(9))
    rest, l_rest = _run(restored, meta["step"], 3)
    assert l_cont == l_rest
    assert _numpy_bits(cont).keys() == _numpy_bits(rest).keys()
    for k, raw in _numpy_bits(cont).items():
        np.testing.assert_array_equal(raw, _numpy_bits(rest)[k], err_msg=k)


def test_async_checkpointer_keeps_newest(tmp_path):
    """Submitted states are copied at submit time (the in-place step may
    overwrite them after), written in the background, and only the
    newest ``keep`` survive, as the reference's writer keeps them."""
    d = str(tmp_path)
    writer = ckpt.AsyncCheckpointer(d, keep=2)
    state = _state()
    snaps = {}
    for s in (1, 2, 3):
        state, _ = _run(state, s, 1)
        writer.submit(s, state, {"s": s})
        snaps[s] = _numpy_bits(state)
    writer.finalize()
    assert sorted(os.listdir(d)) == [f"step_{s:08d}{e}" for s in (2, 3)
                                     for e in (".json", ".npz")]
    assert ckpt.latest_step(d) == 3
    restored, meta = ckpt.restore(d, _state(), step=2)
    assert meta == {"step": 2, "s": 2}
    for k, raw in _numpy_bits(restored).items():
        np.testing.assert_array_equal(raw, snaps[2][k], err_msg=k)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), _state())
    assert ckpt.latest_step(str(tmp_path / "empty")) is None
