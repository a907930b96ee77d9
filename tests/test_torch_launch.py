"""The port's launch layer (``src/repro_torch/launch/``), ``configs/paper.py``
and ``models/base.py``'s shape cells held against the reference.

Pure logic, compared exactly: the sharding rules' resolved specs for
every leaf of every architecture on the reference's 16 x 16 and
2 x 16 x 16 shape-only meshes (default and long-context rules), the
per-device shard shapes, the roofline's analytic terms and rows, and the
paper configuration.  One reference step is compiled: the matmul FLOPs of
the port's traced train step (``hlo_analysis.trace`` on the ``meta``
device) against the reference's ``hlo_analysis.analyze`` of its compiled
HLO, reduced llama3.2-3b on one CPU device.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as JALL_ARCHS
from repro.configs.paper import PAPER as JPAPER
from repro.launch import hlo_analysis as jhlo
from repro.launch import roofline as jroofline
from repro.launch.sharding import ShardingRules as JRules
from repro.launch.sharding import batch_sharding as jbatch_sharding
from repro.launch.sharding import resolve_spec as jresolve
from repro.launch.specs import pick_microbatches as jpick_microbatches
from repro.models.base import SHAPES as JSHAPES
from repro.models.base import ParamSpec as JParamSpec
from repro.models.base import count_params as jcount_params
from repro.models.base import get_arch as jget_arch
from repro.models.base import spec_avals as jspec_avals
from repro.training import trainer as jtrainer

from repro_torch.configs import ALL_ARCHS
from repro_torch.configs.paper import PAPER
from repro_torch.core import pytree
from repro_torch.launch import dryrun, hlo_analysis, roofline, sharding, specs
from repro_torch.launch.mesh import (ShardLayoutError, batch_axes,
                                     make_mesh_auto, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models.base import SHAPES, ParamSpec, ShapeCell, count_params
from repro_torch.models.base import get_arch
from repro_torch.training import trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """The reference's shape-only mesh (resolve_spec reads shape and
    axis_names only)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": FakeMesh({"data": 16, "model": 16}),
          "multi": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _jleaves(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JParamSpec))[0]
    return {jax.tree_util.keystr(p): s for p, s in flat}


def _tleaves(specs):
    return {pytree.keystr(p): s for p, s in pytree.flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, ParamSpec))}


def _spec_trees(arch):
    """(reference, port) ParamSpec trees of ``arch``'s full config: the
    parameters, the AdamW moments and a decode cache."""
    jb, tb = jget_arch(arch), get_arch(arch)
    jtree = {"params": jb.module.param_specs(jb.cfg),
             "opt": jtrainer.state_specs(jb, jb.cfg)["opt"],
             "cache": jb.module.cache_specs(jb.cfg, 128, 4096)}
    ttree = {"params": tb.module.param_specs(tb.cfg),
             "opt": trainer.state_specs(tb, tb.cfg)["opt"],
             "cache": tb.module.cache_specs(tb.cfg, 128, 4096)}
    return _jleaves(jtree), _tleaves(ttree)


def test_arch_lists_and_shape_cells_match_reference():
    assert ALL_ARCHS == JALL_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for arch in ALL_ARCHS:
        jb, tb = jget_arch(arch), get_arch(arch)
        assert tb.skip_cells == jb.skip_cells, arch
        assert tb.skip_reasons == jb.skip_reasons, arch
        assert count_params(tb.module.param_specs(tb.cfg)) == jcount_params(
            jb.module.param_specs(jb.cfg)), arch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_resolve_spec_matches_reference(arch):
    """Every parameter, moment and cache leaf resolves to the reference's
    PartitionSpec on both production meshes, under the default and the
    long-context rules; each shard shape is the dims divided by the
    resolved axes' sizes."""
    jl, tl = _spec_trees(arch)
    assert jl.keys() == tl.keys()
    for long_context in (False, True):
        jrules = JRules.default(long_context=long_context)
        trules = sharding.ShardingRules.default(long_context=long_context)
        assert trules.table == jrules.table
        for name, mesh in MESHES.items():
            for path, js in jl.items():
                ts = tl[path]
                assert (tuple(ts.shape), tuple(ts.axes)) == (
                    tuple(js.shape), tuple(js.axes)), path
                want = tuple(jresolve(js, jrules, mesh))
                got = sharding.resolve_spec(ts, trules, mesh)
                assert got == want, (name, long_context, path, got, want)
                block = sharding.shard_shape(ts.shape, got, mesh)
                for dim, b, a in zip(ts.shape, block, got):
                    n = math.prod(mesh.shape[x] for x in (
                        () if a is None else (a,) if isinstance(a, str)
                        else a))
                    assert b * n == dim, (path, ts.shape, got)


def test_batch_and_serve_shardings_match_reference():
    for mesh in MESHES.values():
        for lc in (False, True):
            jr = JRules.default(long_context=lc)
            tr = sharding.ShardingRules.default(long_context=lc)
            for b in (1, 8, 256):
                want = jbatch_sharding(_AnyMesh(mesh), jr, 3, b).spec
                assert sharding.batch_sharding(mesh, tr, 3, b) == tuple(want)
    assert sharding.serve_sharding(None) == ("serve",)


class _AnyMesh(FakeMesh):
    """A shape-only mesh that NamedSharding accepts (the reference's
    batch_sharding wraps its spec in one)."""

    def __init__(self, mesh):
        super().__init__(mesh.shape)
        self.abstract = jax.sharding.AbstractMesh(
            tuple(mesh.shape.values()), tuple(mesh.shape))

    def __getattr__(self, name):
        return getattr(self.abstract, name)


def test_meshes():
    single, multi = (make_production_mesh(), make_production_mesh(
        multi_pod=True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512 and multi.device.type == "meta"
    assert batch_axes(multi) == ("pod", "data")
    assert batch_axes(single) == ("data",)
    smoke = make_smoke_mesh(device="cpu")
    assert smoke.shape == {"data": 1, "model": 1} and smoke.size == 1
    with pytest.raises(ShardLayoutError, match="distinct devices"):
        make_mesh_auto((1, 2), ("data", "model"),
                       devices=["cuda:0", "cuda:1"])
    assert jpick_microbatches(JSHAPES["train_4k"], MESHES["multi"]) == \
        specs.pick_microbatches(SHAPES["train_4k"], multi)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_roofline_analytic_terms_match_reference(arch):
    assert roofline._total_params(arch) == jroofline._total_params(arch)
    assert roofline._active_params(arch) == jroofline._active_params(arch)
    for shape in SHAPES:
        assert roofline.model_flops(arch, shape) == \
            jroofline.model_flops(arch, shape), shape


def test_build_row_matches_reference():
    """The same costs through both build_row (the TPU v5e row): equal
    rows, energy columns included."""
    breakdown = {"all-reduce": 3.5e9, "all-gather": 1.25e9,
                 "reduce-scatter": 2.0e8, "all-to-all": 0.0,
                 "collective-permute": 0.0}
    mem = {"args": 1.0, "out": 1.0, "temp": 2.0, "alias": 1.0, "peak": 3.0}
    for flops, nbytes in ((4.1e14, 3.3e12), (2e12, 9.9e11), (5e13, 1e9)):
        kw = dict(flops=flops, bytes_accessed=nbytes,
                  collective_bytes=sum(breakdown.values()),
                  collective_breakdown=breakdown,
                  per_collective_count={k: 1 for k in breakdown})
        for arch, shape in (("llama3.2-3b", "train_4k"),
                            ("deepseek-v2-236b", "decode_32k"),
                            ("whisper-large-v3", "prefill_32k")):
            want = jroofline.build_row(arch, shape, "multi", 512,
                                       jhlo.HloCosts(**kw), mem).to_json()
            got = roofline.build_row(arch, shape, "multi", 512,
                                     hlo_analysis.HloCosts(**kw), mem,
                                     hw="TPU_V5E").to_json()
            assert got == want, (arch, shape)
    h = roofline.HARDWARE["H100_SXM"]
    assert (h.hbm_bw, h.peak_flops) == (3.35e12, 989e12)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.ICI_BW) == (
        jroofline.PEAK_FLOPS, jroofline.HBM_BW, jroofline.ICI_BW)


def test_paper_config_matches_reference():
    assert PAPER.map_seed == JPAPER.map_seed
    for a, b in ((PAPER.geometry, JPAPER.geometry),
                 (PAPER.tpu_geometry, JPAPER.tpu_geometry)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(PAPER.fault_model) == dataclasses.asdict(
        JPAPER.fault_model)
    assert PAPER.power_model.p_idle_frac == JPAPER.power_model.p_idle_frac
    tm, jm = PAPER.fault_map(), JPAPER.fault_map()
    np.testing.assert_array_equal(np.asarray(tm.pc_multiplier),
                                  np.asarray(jm.pc_multiplier))
    for v in (0.98, 0.91, 0.85):
        np.testing.assert_array_equal(
            np.asarray(tm.threshold_table(v)).astype(np.uint32),
            np.asarray(jm.threshold_table(v)).astype(np.uint32))
        assert float(PAPER.power_model.savings(v, 0.5)) == pytest.approx(
            float(JPAPER.power_model.savings(v, 0.5)), rel=1e-12)


# reduced llama3.2-3b, batch 4 x 32, two microbatches
FLOPS_CELL = ShapeCell("flops", "train", 32, 4)
# With remat, XLA's compiled program drops recomputed products whose
# results the backward pass never reads; torch.utils.checkpoint reruns
# each period's whole forward, so the port counts more: 1.45% here (with
# remat "none" the two counts are equal).  2% bounds it.
FLOPS_RTOL = 0.02


def test_matmul_flops_match_reference_hlo():
    jb = jget_arch("llama3.2-3b")
    tc = jtrainer.TrainConfig(microbatches=2)
    step = jtrainer.make_train_step(jb, jb.reduced, tc)
    avals = (jspec_avals(jtrainer.state_specs(jb, jb.reduced, tc)),
             {"tokens": jax.ShapeDtypeStruct((4, 32), jnp.int32)})
    want = jhlo.analyze(jax.jit(step).lower(*avals).compile().as_text())
    plan = specs.build_cell(
        "llama3.2-3b", FLOPS_CELL,
        make_mesh_auto((1, 1), ("data", "model"), device="meta"),
        microbatches=2, cfg=get_arch("llama3.2-3b").reduced)
    st, scale = plan.analyze()
    assert scale == 1.0 and st.ops > 0
    assert st.flops >= want.flops
    assert st.flops / want.flops - 1.0 < FLOPS_RTOL


def test_dryrun_cell_memory_and_collectives():
    """The reduced deepseek cell on (1, 1) and (2, 2) meta meshes: args is
    the exact shard bytes of the state and batch (on (1, 1): every byte
    of the train state the port allocates), the MoE psum appears only
    with a model axis (forward, recompute and backward per MoE layer and
    microbatch), FSDP gathers only with a data axis."""
    tb = get_arch("deepseek-v2-lite-16b")
    cfg = tb.reduced
    cell = ShapeCell("mt", "train", 16, 4)
    rows = {}
    for shape in ((1, 1), (2, 2)):
        mesh = make_mesh_auto(shape, ("data", "model"), device="meta")
        rows[shape] = dryrun.run_cell(tb.cfg.arch_id, cell, "smoke", cfg=cfg,
                                      mesh=mesh, microbatches=2)
    state = trainer.init_state(tb, cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    held = sum(t.numel() * t.element_size() for t in pytree.leaves(state))
    assert rows[(1, 1)]["args_bytes"] == held + 4 * 16 * 4
    assert rows[(1, 1)]["memory_gb"]["alias"] * 2**30 == held
    assert rows[(2, 2)]["args_bytes"] < rows[(1, 1)]["args_bytes"]
    one, two = (rows[s]["collective_breakdown"] for s in ((1, 1), (2, 2)))
    assert sum(one.values()) == 0.0
    assert two["all-reduce"] > 0 and two["all-gather"] > 0
    n_moe = cfg.n_layers - 1
    plan = specs.build_cell(tb.cfg.arch_id, cell, make_mesh_auto(
        (2, 2), ("data", "model"), device="meta"), microbatches=2, cfg=cfg)
    st, scale = plan.analyze()
    assert scale == 0.5          # one data shard, split over 2 model shards
    psums = [c for c in st.collectives if c[1] == "model"]
    assert len(psums) == 3 * n_moe * 2
    for row in rows.values():
        assert row["status"] == "ok" and row["hardware"] == "H100_SXM"
        assert row["memory_gb"]["peak"] > row["memory_gb"]["args"]
        json.dumps(row)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "long_500k"])
def test_dryrun_serving_cells(arch, kind):
    """Prefill and decode cells of reduced configs on a (2, 2) meta mesh
    (K7 / K8's wrappers trace their plain versions on ``meta``): args is
    the shard bytes of the parameters, the cache (decode) and the batch;
    long_500k keeps its batch of one whole and shards the cache."""
    tb = get_arch(arch)
    cfg = tb.reduced
    shape = {"prefill": ShapeCell("prefill_s", "prefill", 32, 4),
             "decode": ShapeCell("decode_s", "decode", 32, 4),
             "long_500k": ShapeCell("long_500k", "decode", 64, 1)}[kind]
    mesh = make_mesh_auto((2, 2), ("data", "model"), device="meta")
    plan = specs.build_cell(arch, shape, mesh, cfg=cfg)
    assert plan.local_batch == (1 if kind == "long_500k" else 2)
    rules = plan.rules
    want = sharding.tree_shard_bytes(tb.module.param_specs(cfg), rules, mesh)
    if shape.kind == "decode":
        want += sharding.tree_shard_bytes(tb.module.cache_specs(
            cfg, shape.global_batch, shape.seq_len), rules, mesh) + 4
    # the int32 tokens of one device's rows
    want += 4 * plan.local_batch * (1 if shape.kind == "decode"
                                    else shape.seq_len)
    row = dryrun.run_cell(arch, shape, "smoke", cfg=cfg, mesh=mesh)
    assert row["status"] == "ok" and row["args_bytes"] == want
    assert row["hlo_flops_per_chip"] > 0 and row["memory_gb"]["temp"] > 0
    # serving has no gradients: only the MoE's psum over the model axis
    assert (sum(row["collective_breakdown"].values()) > 0) == (
        arch.startswith("deepseek"))


def test_dryrun_main_streams_and_resumes(tmp_path, capsys):
    out = tmp_path / "dry.json"
    argv = ["--arch", "llama3.2-3b,yi-34b", "--shape", "long_500k",
            "--mesh", "both", "--out", str(out)]
    dryrun.main(argv)
    rows = json.loads(out.read_text())
    assert set(rows) == {f"{a}|long_500k|{m}" for a in ("llama3.2-3b",
                                                        "yi-34b")
                         for m in ("single", "multi")}
    assert all(r["status"] == "skipped" for r in rows.values())
    capsys.readouterr()
    dryrun.main(argv)
    assert capsys.readouterr().out.count("[cached]") == 4
