"""The paper's characterization API in the port, held against the JAX
reference, and the port's public surface.

Every number is float64 numpy in both packages, so the port's equal the
reference's exactly: the fault model's regions and guardband, a fault
map's per-stack rate (Fig. 4), expected faults per pattern, fault-free
probability and usable PCs (Fig. 6), the power model's alpha*C_L*f (Fig.
3), watts and energy, domain capacity, the geometries, ring lengths and
period layouts.  The paper's anchors (``benchmarks/paper_figs.py``) hold
in the port.  Every public module-level name and class attribute of each
reference module exists in its port counterpart, but for the JAX-only
names of ``JAX_ONLY``, each mapped to the port function that does its
job.
"""
import ast
import dataclasses
import importlib
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import domains as jdomains
from repro.core import faultmap as jfaultmap
from repro.core import faultmodel as jfaultmodel
from repro.core import hbm as jhbm
from repro.core import voltage as jvoltage
from repro.models import base as jbase
from repro.models import dense as jdense
from repro.models import stack as jstack

from repro_torch.core import domains, faultmap, faultmodel, hbm, pytree
from repro_torch.core import voltage
from repro_torch.models import base, dense, stack

SRC = Path(__file__).resolve().parents[1] / "src"
GRID = np.round(np.arange(0.80, 1.2501, 0.01), 2)
# the per-PC figures cost one rate evaluation per PC and call: every PC
# on a 90 mV grid over the same span (0.80, 0.89, V_MIN, ..., 1.25)
PC_GRID = GRID[::9]
RATES = (0.0, 1e-6, 1e-3)
UTILS = (0.0, 0.25, 0.5, 1.0)
GEOMETRIES = ("vcu128", "tpu_v5e")


def _maps(name):
    return (jfaultmap.FaultMap.from_seed(jhbm.GEOMETRIES[name],
                                         seed=jfaultmap.PAPER_MAP_SEED),
            faultmap.FaultMap.from_seed(hbm.GEOMETRIES[name],
                                        seed=faultmap.PAPER_MAP_SEED))


def test_fault_model_region_and_guardband_equal_reference():
    for v in GRID:
        assert (faultmodel.FaultModel.region(float(v))
                == jfaultmodel.FaultModel.region(float(v))), v
    assert (faultmodel.FaultModel.guardband_fraction()
            == jfaultmodel.FaultModel.guardband_fraction())
    assert faultmodel.DEFAULT_FAULT_MODEL.region(0.5) == "crash"


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_fault_map_rates_equal_reference(geometry):
    """Each stack's mean rate and the usable PCs at each tolerable rate
    per voltage of the grid; each PC's expected faults under every
    pattern and its fault-free probability on the 90 mV grid."""
    jm, tm = _maps(geometry)
    geo = tm.geometry
    for v in GRID:
        v = float(v)
        for s in range(geo.num_stacks):
            assert tm.stack_mean_rate(v, s) == jm.stack_mean_rate(v, s)
        for rate in RATES:
            assert (tm.num_usable_pcs(v, rate)
                    == jm.num_usable_pcs(v, rate)), (v, rate)
    for v in PC_GRID:
        v = float(v)
        for pc in range(geo.num_pcs):
            for pattern in ("zeros", "ones", "both"):
                assert (tm.expected_faults(v, pc, pattern)
                        == jm.expected_faults(v, pc, pattern)), (v, pc)
            assert tm.fault_free_prob(v, pc) == jm.fault_free_prob(v, pc)


def test_power_model_equal_reference():
    tp, jp = voltage.DEFAULT_POWER_MODEL, jvoltage.DEFAULT_POWER_MODEL
    for v in GRID:
        for u in UTILS:
            assert tp.alpha_clf(v, u) == jp.alpha_clf(v, u)
            assert tp.watts(v, u) == jp.watts(v, u)
            assert tp.watts(v, u, 35.0) == jp.watts(v, u, 35.0)
            assert (tp.energy_joules(0.25, v, u)
                    == jp.energy_joules(0.25, v, u))
    np.testing.assert_array_equal(tp.alpha_clf(GRID), jp.alpha_clf(GRID))
    assert voltage.W_HBM_NOMINAL == jvoltage.W_HBM_NOMINAL_V5E


def test_capacity_geometries_rings_and_layouts_equal_reference():
    assert set(hbm.GEOMETRIES) == set(jhbm.GEOMETRIES)
    for name, g in hbm.GEOMETRIES.items():
        assert dataclasses.asdict(g) == dataclasses.asdict(
            jhbm.GEOMETRIES[name])
        for pcs in ((0,), (3, 7, 19), tuple(range(g.num_pcs))):
            assert (domains.MemoryDomain("d", 0.9, pcs).capacity_bytes(g)
                    == jdomains.MemoryDomain("d", 0.9, pcs).capacity_bytes(
                        jhbm.GEOMETRIES[name]))
    for arch in jbase.list_archs():
        jb, tb = jbase.get_arch(arch), base.get_arch(arch)
        jspecs = jb.module.cache_specs(jb.reduced, 2, 24)
        tspecs = tb.module.cache_specs(tb.reduced, 2, 24)
        want = jax.tree_util.tree_leaves(jbase.ring_lengths(jspecs))
        got = pytree.leaves(base.ring_lengths(tspecs))
        assert got == want, arch
        for cfg in ("cfg", "reduced"):
            jc, tc = getattr(jb, cfg), getattr(tb, cfg)
            if hasattr(jb.module, "layout"):
                assert (tb.module.layout(tc).n_layers
                        == jb.module.layout(jc).n_layers), (arch, cfg)
    assert (stack.layout_from_kinds(("a", "b") * 3 + ("a",), 2, 1).n_layers
            == jstack.layout_from_kinds(("a", "b") * 3 + ("a",), 2,
                                        1).n_layers == 7)
    assert dense.SUPPORTS_PADDED_PREFILL is jdense.SUPPORTS_PADDED_PREFILL


def test_paper_anchors_hold_in_the_port():
    """The reference's benchmarks/paper_figs.py anchors (C1-C3, C5, C7,
    C10 and the 19% guardband), on the port's models."""
    fm, pm = faultmodel.DEFAULT_FAULT_MODEL, voltage.DEFAULT_POWER_MODEL
    fmap = faultmap.FaultMap.from_seed(hbm.VCU128,
                                       seed=faultmap.PAPER_MAP_SEED)
    assert abs(fm.guardband_fraction() - 0.19) < 0.005
    for util in (0.0, 0.25, 0.5, 0.75, 1.0):
        assert abs(float(pm.savings(faultmodel.V_MIN, util)) - 1.5) < 0.01
        assert abs(float(pm.savings(0.85, util)) - 2.3) < 0.05
    assert abs(float(pm.power(faultmodel.V_NOM, 0.0)) - 1 / 3) < 1e-6
    assert abs(float(pm.alpha_clf(0.98)) - 1.0) < 0.03
    assert abs((1 - float(pm.alpha_clf(0.85))) - 0.14) < 0.01
    assert fmap.stack_mean_rate(0.98, 0) == 0.0
    assert fmap.stack_mean_rate(0.83, 0) > 0.99
    assert fmap.stack_mean_rate(0.92, 1) > fmap.stack_mean_rate(0.92, 0)
    assert fmap.num_usable_pcs(0.98, 0.0) == hbm.VCU128.num_pcs


# ---------------------------------------------------------------------------
# the public surface
# ---------------------------------------------------------------------------


# Reference names with no port counterpart of the same name: each is
# JAX-, Pallas- or TPU-only, and names the port code that does its job.
JAX_ONLY = {
    "core/engine.py:count_pallas_calls":
        "kernels/_build.py::launch_counts",
    "core/faultmodel.py:FaultModel.components_jnp":
        "core/faultmodel.py::FaultModel.components_t",
    "core/hashing.py:rate_to_u32_threshold_jnp":
        "core/hashing.py::rate_to_u32_threshold_t",
    "core/hashing.py:rate_to_plane_threshold_jnp":
        "core/hashing.py::rate_to_plane_threshold_t",
    # a TPU v5e figure; the port names the same assumed 20 W for what it is
    "core/voltage.py:W_HBM_NOMINAL_V5E": "core/voltage.py::W_HBM_NOMINAL",
    "kernels/bitflip/bitflip.py:bitflip_pallas":
        "kernels/bitflip/bitflip.py::bitflip",
    "kernels/bitflip/bitflip.py:arena_bitflip_pallas":
        "kernels/bitflip/bitflip.py::arena_bitflip",
    # the Pallas block's TPU (sublane, lane) tile of a 4096-word block
    "kernels/bitflip/bitflip.py:BLOCK_SUBLANES":
        "kernels/bitflip/bitflip.py::BLOCK_WORDS",
    "kernels/bitflip/bitflip.py:BLOCK_LANES":
        "kernels/bitflip/bitflip.py::BLOCK_WORDS",
    # Pallas interpret mode: a port wrapper picks kernel or plain version
    # by the device of its tensors
    "kernels/bitflip/ops.py:default_interpret":
        "kernels/bitflip/ops.py::bitflip",
    "kernels/ecc/ecc.py:ecc_pallas": "kernels/ecc/ecc.py::segment_ecc",
    "kernels/ecc/ecc.py:arena_ecc_pallas": "kernels/ecc/ecc.py::arena_ecc",
    "kernels/flash_attention/flash_attention.py:flash_attention_pallas":
        "kernels/flash_attention/flash_attention.py::flash_attention_fwd",
    "kernels/flash_attention/flash_attention.py:DEFAULT_BQ":
        "kernels/flash_attention/flash_attention.py::TILES",
    "kernels/flash_attention/flash_attention.py:DEFAULT_BKV":
        "kernels/flash_attention/flash_attention.py::TILES",
    "kernels/rglru/rglru.py:rglru_pallas":
        "kernels/rglru/rglru.py::rglru_scan_fwd",
    "kernels/rglru/rglru.py:DEFAULT_CHUNK":
        "kernels/rglru/rglru.py::scan_chunks",
    "kernels/rglru/rglru.py:DEFAULT_BTILE":
        "kernels/rglru/rglru.py::scan_chunks",
    "serving/readpath.py:ReadPathCtx.interpret":
        "kernels/flash_attention/faulty.py::faulty_decode_attention",
    "serving/paged.py:PagedServingCtx.interpret":
        "kernels/flash_attention/faulty.py::paged_decode_attention",
    # the HLO text parser: the port's analysis traces the step on `meta`
    "launch/hlo_analysis.py:Computation": "launch/hlo_analysis.py::trace",
    "launch/hlo_analysis.py:Instr": "launch/hlo_analysis.py::trace",
    "launch/hlo_analysis.py:DTYPE_BYTES": "launch/hlo_analysis.py::trace",
    "launch/hlo_analysis.py:parse_hlo": "launch/hlo_analysis.py::trace",
    "launch/hlo_analysis.py:computation_weights":
        "launch/hlo_analysis.py::trace",
    "launch/specs.py:CellPlan.lower": "launch/specs.py::CellPlan.analyze",
    # the int-position functional ring write; the port writes in place
    "models/cache.py:ring_update": "models/cache.py::ring_write",
    # the jitted, donated lax.scan decode and its driver switch: the port
    # captures one decode step as a CUDA graph (generate(capture=...))
    "serving/engine.py:DecodeEngine.decode_all":
        "serving/captured.py::CapturedStep",
    "serving/engine.py:ServeConfig.decode": "serving/engine.py::generate",
    # a traced lane mask of the one compiled mixed step; the port's mixed
    # step runs eagerly and names its prefilling slots on the host
    "serving/paged.py:MixedServingCtx.dec":
        "serving/paged.py::MixedServingCtx.prefill_slots",
    # a jax.random key; the port samples from a torch.Generator
    "serving/scheduler.py:Request.key": "serving/scheduler.py::Request",
}


def _public_names(path: Path):
    """Module-level names a reference file defines, and the attributes of
    its public classes, none starting with an underscore."""
    mod, cls = set(), {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            mod.add(node.name)
            if isinstance(node, ast.ClassDef):
                attrs = set()
                for n in node.body:
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
                        attrs.add(n.name)
                    elif isinstance(n, ast.Assign):
                        attrs |= {t.id for t in n.targets
                                  if isinstance(t, ast.Name)}
                    elif (isinstance(n, ast.AnnAssign)
                          and isinstance(n.target, ast.Name)):
                        attrs.add(n.target.id)
                cls[node.name] = attrs
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name):
                        mod.add(e.id)
        elif (isinstance(node, ast.AnnAssign)
              and isinstance(node.target, ast.Name)):
            mod.add(node.target.id)
    names = {n for n in mod if not n.startswith("_")}
    names |= {f"{c}.{a}" for c, attrs in cls.items() if not c.startswith("_")
              for a in attrs if not a.startswith("_")}
    return names


def _port_module(rel: str):
    name = "repro_torch." + rel[:-3].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


def _has(obj, dotted: str) -> bool:
    for part in dotted.split("."):
        fields = getattr(obj, "__dataclass_fields__", {})
        if not hasattr(obj, part) and part not in fields:
            return False
        obj = getattr(obj, part, None)
    return True


PACKAGES = sorted(p.name for p in (SRC / "repro").iterdir() if p.is_dir()
                  and p.name != "__pycache__")


@pytest.mark.parametrize("package", PACKAGES)
def test_port_has_every_public_name_of_the_reference(package):
    """Parsed from the reference's source (jax is never imported for it),
    looked up with hasattr on the port's imported modules."""
    missing, listed = [], set()
    for path in sorted((SRC / "repro" / package).rglob("*.py")):
        rel = str(path.relative_to(SRC / "repro"))
        port = _port_module(rel)
        for name in sorted(_public_names(path)):
            if _has(port, name):
                continue
            key = f"{rel}:{name}"
            if f"{rel}:{name.split('.')[0]}" in JAX_ONLY and "." in name:
                continue                # an attribute of a JAX-only class
            if key in JAX_ONLY:
                listed.add(key)
            else:
                missing.append(key)
    assert not missing, missing
    # every allowlist entry of this package is still missing, and names
    # port code that exists
    mine = {k for k in JAX_ONLY if k.startswith(package + "/")}
    assert listed == mine, sorted(mine - listed)
    for key in mine:
        rel, name = JAX_ONLY[key].split("::")
        assert _has(_port_module(rel), name), JAX_ONLY[key]
