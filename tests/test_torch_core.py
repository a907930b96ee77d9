"""The PyTorch port's fault-model core held against the JAX reference.

Integer paths (hash, multipliers, threshold tables, placement, word
views) must match bit for bit.  Inputs are made from numpy seeds and
handed to both packages as numpy arrays.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import hashing as jhash
from repro.core.domains import MemoryDomain as JDomain
from repro.core.domains import place_groups as jplace
from repro.core.faultmap import FaultMap as JFaultMap
from repro.core.faultmap import _threshold_table_np
from repro.core.hbm import HBMGeometry as JGeometry
from repro.core.hbm import VCU128 as JVCU128
from repro.core.voltage import DEFAULT_POWER_MODEL as JPOWER
from repro.kernels.bitflip import ops as jops
from repro.models.base import get_arch as jget_arch
from repro.models.base import spec_avals as jspec_avals

import repro_torch
from repro_torch import convert
from repro_torch.core import engine, hashing
from repro_torch.core.domains import MemoryDomain, place_groups
from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
from repro_torch.core.hbm import VCU128, HBMGeometry
from repro_torch.core.voltage import DEFAULT_POWER_MODEL
from repro_torch.kernels.bitflip import ops
from repro_torch.models.base import get_arch, spec_avals


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SRC = Path(__file__).resolve().parents[1] / "src"
TINY = dict(name="tiny", num_stacks=2, channels_per_stack=2,
            pcs_per_channel=2, bytes_per_pc=64 * 1024)
# Voltages the injection, attention and serving tests run at.
TEST_VOLTAGES = (0.86, 0.87, 0.88, 0.90, 0.91, 0.95, 0.98)
STREAMS = (jhash.STREAM_WORD_01, jhash.STREAM_WORD_10, jhash.STREAM_BITPOS_01,
           jhash.STREAM_BITPOS_10, jhash.STREAM_ROW, jhash.STREAM_BITPLANE)


@pytest.mark.parametrize("stream", STREAMS)
def test_hash_stream_bit_exact(stream):
    rng = np.random.RandomState(stream & 0xFFFF)
    counters = rng.randint(0, 2 ** 32, size=2 ** 16, dtype=np.uint64
                           ).astype(np.uint32)
    for seed in (0, 7, PAPER_MAP_SEED, 0xFFFFFFFF):
        ref = np.asarray(jhash.hash_stream(seed, stream,
                                           jnp.asarray(counters)))
        got = hashing.hash_stream(seed, stream,
                                  torch.from_numpy(counters.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), ref)


def test_mix32_int_and_word_views_of_hash():
    for x in (0, 1, 0xDEADBEEF, 0xFFFFFFFF, 469 ^ jhash.STREAM_ROW):
        assert hashing.mix32_int(x) == jhash.mix32_int(x)
    vals = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1], dtype=torch.int64)
    np.testing.assert_array_equal(hashing.as_u64(hashing.as_i32(vals)), vals)


@pytest.mark.parametrize("geometry,seed", [
    ("vcu128", 0), ("vcu128", PAPER_MAP_SEED), ("tiny", 7)])
def test_fault_map_multipliers_bit_exact(geometry, seed):
    tg = VCU128 if geometry == "vcu128" else HBMGeometry(**TINY)
    jg = JVCU128 if geometry == "vcu128" else JGeometry(**TINY)
    got = FaultMap.from_seed(tg, seed).pc_multiplier
    ref = JFaultMap.from_seed(jg, seed).pc_multiplier
    assert got == ref


@pytest.mark.parametrize("v", TEST_VOLTAGES + (0.80, 1.20))
def test_threshold_table_equal_at_test_voltages(v):
    tmap = FaultMap.from_seed(VCU128, PAPER_MAP_SEED)
    jmap = JFaultMap.from_seed(JVCU128, PAPER_MAP_SEED)
    got = tmap.threshold_table(v).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, _threshold_table_np(jmap, v))
    for pc in (0, 4, 31):
        assert (dataclasses.asdict(tmap.thresholds(v, pc))
                == dataclasses.asdict(jmap.thresholds(v, pc)))


def test_threshold_table_f1_grid_count():
    """F1: cells of the 81-voltage grid (0.80..1.20 V, 5 mV) where the
    port's table differs from the reference's.  A plain float32
    transcription differed in 354 of 28,512 cells; the port follows
    XLA's folding, reciprocal and fused multiply-add, and the count is
    held at zero here (the bound leaves room for a different XLA)."""
    tmap = FaultMap.from_seed(VCU128, PAPER_MAP_SEED)
    jmap = JFaultMap.from_seed(JVCU128, PAPER_MAP_SEED)
    diff = cells = 0
    for i in range(81):
        v = round(0.80 + 0.005 * i, 3)
        got = tmap.threshold_table(v).numpy().view(np.uint32)
        ref = _threshold_table_np(jmap, v)
        diff += int((got != ref).sum())
        cells += ref.size
    print(f"F1 grid: {diff} of {cells} cells differ")
    assert cells == 28512
    assert diff <= 28, diff


@pytest.mark.parametrize("v", (0.86, 0.88, 0.91))
def test_usable_pcs_and_power_model_match(v):
    tmap = FaultMap.from_seed(VCU128, PAPER_MAP_SEED)
    jmap = JFaultMap.from_seed(JVCU128, PAPER_MAP_SEED)
    np.testing.assert_array_equal(tmap.usable_pcs(v, 1.0),
                                  jmap.usable_pcs(v, 1.0))
    np.testing.assert_array_equal(tmap.reliability_order(v),
                                  jmap.reliability_order(v))
    assert float(DEFAULT_POWER_MODEL.savings(v, 0.5)) == float(
        JPOWER.savings(v, 0.5))


def _jax_cache_avals(cfg, batch, max_len):
    return jspec_avals(jget_arch("llama3.2-3b").module.cache_specs(
        cfg, batch, max_len))


@pytest.mark.parametrize("which", ["reduced_bf16", "reduced_f32", "full"])
def test_place_groups_block_tables_bit_exact(which):
    """Placement of the llama cache: same keystr paths in the same order,
    same segments, same block tables (the addresses every fault bit
    hangs on) -- including the full-width main-path cache."""
    jb, tb = jget_arch("llama3.2-3b"), get_arch("llama3.2-3b")
    if which == "full":
        jcfg, tcfg, batch, max_len = jb.cfg, tb.cfg, 4, 1024
        pcs = tuple(range(16))
    else:
        jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if which == "reduced_bf16"
                    else (jnp.float32, torch.float32))
        jcfg = dataclasses.replace(jb.reduced, dtype=jdt)
        tcfg = dataclasses.replace(tb.reduced, dtype=tdt)
        batch, max_len, pcs = 2, 40, tuple(range(32))
    jp = jplace({"kv_cache": _jax_cache_avals(jcfg, batch, max_len)},
                {"kv_cache": "kv"}, {"kv": JDomain("kv", 0.91, pcs)},
                JVCU128)["kv_cache"]
    tp = place_groups({"kv_cache": spec_avals(tb.module.cache_specs(
        tcfg, batch, max_len))}, {"kv_cache": "kv"},
        {"kv": MemoryDomain("kv", 0.91, pcs)}, VCU128)["kv_cache"]
    assert [lp.path for lp in tp.leaves] == [lp.path for lp in jp.leaves]
    assert tp.leaves[0].path == "['periods']['s0_global']['k']"
    for a, b in zip(tp.leaves, jp.leaves):
        assert a.n_words == b.n_words
        assert [dataclasses.astuple(s) for s in a.segments] == [
            dataclasses.astuple(s) for s in b.segments]
    tt, jt = tp.block_table(), jp.block_table()
    assert tt.block_pc == jt.block_pc
    assert tt.block_base == jt.block_base
    assert tt.leaf_blocks == jt.leaf_blocks
    if which == "full":
        assert tt.num_blocks == 28700           # 448 MiB K/V + 448 KiB pos
    bb, bp = engine.leaf_block_tables(tp)[0]
    np.testing.assert_array_equal(
        bb.numpy().view(np.uint32),
        np.asarray(jt.block_base[:bb.shape[0]], np.uint32))


@pytest.mark.parametrize("dtype,n", [
    ("float32", 37), ("bfloat16", 37), ("bfloat16", 64), ("int8", 37),
    ("int8", 64), ("int32", 5)])
def test_to_u32_from_u32_bit_exact(dtype, n):
    rng = np.random.RandomState(n)
    if dtype in ("float32", "bfloat16"):
        raw = rng.randn(n).astype(np.float32)
        arr = raw.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                         else np.float32)
    else:
        arr = rng.randint(-100, 100, n).astype(dtype)
    ref_u32, _ = jops.to_u32(jnp.asarray(arr))
    t = convert.tensor_from_numpy(arr)
    u32, meta = ops.to_u32(t)
    np.testing.assert_array_equal(u32.numpy().view(np.uint32),
                                  np.asarray(ref_u32))
    back = ops.from_u32(u32, meta)
    assert back.dtype == t.dtype and back.shape == t.shape
    np.testing.assert_array_equal(convert.tensor_to_numpy_bits(back),
                                  convert.tensor_to_numpy_bits(t))


def test_argmax_takes_first_nan_like_jnp():
    rows = np.array([[1.0, np.nan, 5.0, np.nan], [3.0, 7.0, 7.0, 1.0],
                     [np.inf, np.nan, 2.0, 2.0], [np.nan, np.nan, 0, 0]],
                    np.float32)
    ref = np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1))
    from repro_torch.serving.engine import sample_tokens
    got = sample_tokens(torch.from_numpy(rows), 0.0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_port_imports_neither_jax_nor_repro():
    """Every ``.py`` file of the reference package has a counterpart in
    the port, and importing every module of the port (the launch layer,
    ``models/dist.py`` and ``configs/paper.py`` among them) leaves jax
    and the reference package out of sys.modules."""
    ref, port = SRC / "repro", SRC / "repro_torch"
    missing = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py")
                     if not (port / p.relative_to(ref)).exists())
    assert not missing, missing
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in ('launch.sharding', 'launch.specs', 'launch.dryrun',"
        " 'launch.hlo_analysis', 'launch.roofline', 'launch.train',"
        " 'launch.mesh', 'models.dist', 'configs.paper',"
        " 'examples.elastic_train'):\n"
        "    assert 'repro_torch.' + n in names, n\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.models.base import init_params
    from repro_torch.serving.engine import ServeConfig, generate
    tb = get_arch("llama3.2-3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(tb, tb.reduced, {}, {"tokens": np.zeros((1, 4), np.int32)},
                 ServeConfig(max_len=8, max_new_tokens=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tb.module.param_specs(tb.reduced))
    assert repro_torch.resolve_device("cpu").type == "cpu"
