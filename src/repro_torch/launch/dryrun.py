"""Dry run: plan and analyze every (arch x shape x mesh) cell and extract
the roofline terms (port of :mod:`repro.launch.dryrun`).

The reference lowers and compiles each cell AOT on 512 forced host
devices.  The port plans each cell on a mesh of ``meta`` positions
(:func:`repro_torch.launch.mesh.make_production_mesh`) and runs its step
once on the ``meta`` device under
:mod:`repro_torch.launch.hlo_analysis`: a static analysis that computes
and allocates nothing, and needs no card.

Per-device memory, as the reference's ``memory_analysis`` reports it:
``args`` is the exact sum of one device's shard bytes of every input,
``temp`` the trace's peak of live bytes beyond the arguments (scaled as
:meth:`repro_torch.launch.specs.CellPlan.analyze` says), ``out`` the
outputs (a donated input the step writes in place counts as output and
as ``alias``), ``peak = args + out + temp - alias``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      [--arch all|<id>[,<id>...]] [--shape all|<name>] \\
      [--mesh both|single|multi] [--hw H100_SXM|TPU_V5E] \\
      [--out results/dryrun_torch.json]

Rows stream to the JSON file as each cell ends; rerunning skips cells
already present (``--force`` redoes them).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import ALL_ARCHS
from repro_torch.launch import hlo_analysis, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models.base import SHAPES, get_arch

GIB = 2.0 ** 30


def run_cell(arch: str, shape, mesh_name: str, *, rule_overrides=None,
             microbatches=None, remat=None, cfg=None, mesh=None,
             hw: str = "H100_SXM") -> dict:
    """One cell's row.  ``shape`` is a SHAPES name or a ShapeCell;
    ``mesh`` (default: the production mesh ``mesh_name`` names) and
    ``cfg`` (default: the arch's full config) may be given."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
    chips = mesh.size
    t0 = time.time()
    plan = build_cell(arch, shape, mesh, rule_overrides=rule_overrides,
                      microbatches=microbatches, remat=remat, cfg=cfg)
    t_plan = time.time() - t0
    t0 = time.time()
    step, scale = plan.analyze()
    t_trace = time.time() - t0

    args = plan.arg_bytes()
    alias = plan.donated_bytes()
    out = alias + step.out_bytes * scale
    temp = step.peak_temp_bytes * scale
    memory_gb = {
        "args": args / GIB,
        "out": out / GIB,
        "temp": temp / GIB,
        "alias": alias / GIB,
        "peak": (args + out + temp - alias) / GIB,
    }
    costs = hlo_analysis.analyze(
        step, layout=plan.collective_layout(),
        microbatches=plan.microbatches,
        batch_axes_size=plan.dist.data_size, scale=scale)
    row = roofline.build_row(arch, plan.shape, mesh_name, chips, costs,
                             memory_gb, hw=hw, cfg=cfg)
    out = row.to_json()
    out.update({
        "status": "ok",
        "hardware": hw,
        "args_bytes": args,
        "lower_s": round(t_plan, 1),
        "compile_s": round(t_trace, 1),
        "xla_flops_unweighted": step.flops,
        "xla_bytes_unweighted": step.bytes_accessed,
        "microbatches": plan.microbatches,
    })
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["both", "single", "multi"])
    ap.add_argument("--hw", default="H100_SXM",
                    choices=sorted(roofline.HARDWARE))
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ALL_ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)

    for arch in archs:
        bundle = get_arch(arch)
        for shape in shapes:
            for mesh_name in meshes:
                key = f"{arch}|{shape}|{mesh_name}"
                if key in results and results[key].get("status") in (
                        "ok", "skipped"):
                    print(f"[cached] {key}")
                    continue
                if shape in bundle.skip_cells:
                    results[key] = {
                        "status": "skipped",
                        "reason": bundle.skip_reasons.get(shape, "")}
                    print(f"[skip]   {key}: "
                          f"{bundle.skip_reasons.get(shape, '')[:60]}")
                else:
                    print(f"[run]    {key} ...", flush=True)
                    try:
                        results[key] = run_cell(arch, shape, mesh_name,
                                                hw=args.hw)
                        r = results[key]
                        print(f"  ok: peak {r['memory_gb']['peak']:.1f} GiB"
                              f"/chip, bottleneck {r['bottleneck']}, "
                              f"trace {r['compile_s']}s", flush=True)
                    except Exception as e:  # noqa: BLE001 (row, exit 1)
                        results[key] = {"status": "failed",
                                        "error": f"{type(e).__name__}: {e}",
                                        "trace": traceback.format_exc()[-2000:]}
                        print(f"  FAILED: {e}", flush=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r.get("status") == "ok")
    n_skip = sum(1 for r in results.values()
                 if r.get("status") == "skipped")
    n_fail = sum(1 for r in results.values()
                 if r.get("status") == "failed")
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped "
          f"(documented), {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
