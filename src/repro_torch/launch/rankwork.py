"""Rank programs: the sharded paged fleet and MoE training over ranks.

  python -m repro_torch.launch.rankwork --spec SPEC.json --out DIR \\
      --world 2 --rank R --addr 127.0.0.1 --port P

(:func:`repro_torch.launch.ranks.launch` starts every rank.)  The spec
(JSON) names the group's ``devices`` (one per rank; by default
:func:`repro_torch.launch.ranks.rank_devices` of ``device``) and a list
of ``runs``, each run in turn on the same group:

- ``{"kind": "psum", ...}``: :func:`repro_torch.models.dist.psum_model`
  and :func:`~repro_torch.models.dist.model_grad_sum` on a (1, world)
  mesh, forward and backward, on seeded inputs.
- ``{"kind": "train", ...}``: MoE training on a rank mesh (``mesh``:
  [data, model]) from a seeded init (or a logical checkpoint through
  ``restore_ranks``), the rank's rows
  of each global batch, an optional undervolt plan; every K1/K2 call of
  the first step held against its plain version; the state dumped
  (``npz``) or digested, strided samples of the first moments
  (``samples``: words a leaf), an optional checkpoint in the logical
  layout; each step's wall and collective ms.
- ``{"kind": "fleet", ...}``: the paged scheduler over a serve mesh of
  one or more shards a rank; every local request replayed alone through
  ``generate()`` on its shard's plan on this rank's device; K4's
  launches counted, one call held against its plain version.

Each rank writes ``DIR/rank<R>.json`` (and ``rank<R>_<run>.npz`` for
dumped states).  Imports no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.core import pytree
from repro_torch.core.domains import MemoryDomain
from repro_torch.core import hbm
from repro_torch.kernels import _build
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_rank_mesh, make_serve_mesh
from repro_torch.launch.rankstate import (leaf_samples, split_state,
                                          state_digest, state_expert_dims)
from repro_torch.models import base
from repro_torch.models.dist import DistContext, model_grad_sum, psum_model
from repro_torch.training.undervolt import UndervoltPlan

_GEOMETRIES = {g.name: g for g in (hbm.VCU128, hbm.TPU_V5E)}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---- specs ----------------------------------------------------------------


def plan_spec(plan) -> Any:
    """An :class:`UndervoltPlan` (policy-driven) as JSON-able data."""
    if plan is None:
        return None
    return {"geometry": plan.geometry.name, "map_seed": plan.map_seed,
            "mitigation": plan.mitigation, "policy": dict(plan.policy),
            "domains": [[d.name, d.voltage, list(d.pc_ids), d.ecc]
                        for d in plan.domains.values()]}


def plan_from_spec(spec) -> Any:
    if spec is None:
        return None
    return UndervoltPlan(
        domains={n: MemoryDomain(n, float(v), tuple(int(p) for p in pcs),
                                 ecc=bool(ecc))
                 for n, v, pcs, ecc in spec["domains"]},
        policy=dict(spec["policy"]), geometry=_GEOMETRIES[spec["geometry"]],
        map_seed=int(spec["map_seed"]), mitigation=spec["mitigation"])


def model_cfg(run) -> Any:
    """The run's bundle and config: the arch's ``reduced`` (default) or
    full config, with ``overrides`` (``dtype`` by name)."""
    bundle = base.get_arch(run["arch"])
    cfg = bundle.cfg if run.get("config") == "full" else bundle.reduced
    over = dict(run.get("overrides") or {})
    if "dtype" in over:
        over["dtype"] = _DTYPES[over["dtype"]]
    return bundle, dataclasses.replace(cfg, **over)


def _load_npz(path, tree, dev):
    """``tree``'s leaves replaced by the npz's arrays (keyed by keystr),
    cast to each leaf's dtype, on ``dev``."""
    with np.load(path) as data:
        out = pytree.tree_map(lambda t: t, tree)
        for p, leaf in pytree.flatten_with_path(tree):
            t = torch.from_numpy(np.array(data[pytree.keystr(p)])).to(
                device=dev, dtype=leaf.dtype)
            if leaf.requires_grad:
                t.requires_grad_(True)
            pytree.set_path(out, p, t)
    return out


def init_model_params(run, bundle, cfg, dev):
    """Parameters of the run's ``init``: ``{"seed": s}`` draws them with a
    generator seeded ``s`` on ``dev`` (``"on_host": true``: on the CPU,
    then moved), ``{"npz": path}`` loads them; ``"mla_fan_in": true``
    rescales MLA's head-split projections."""
    init = run["init"]
    specs = bundle.module.param_specs(cfg)
    if "npz" in init:
        params = base.init_params(specs, torch.Generator().manual_seed(0),
                                  device="cpu")
        params = _load_npz(init["npz"], params, dev)
    elif init.get("on_host"):
        params = pytree.tree_map(lambda t: t.to(dev), base.init_params(
            specs, torch.Generator().manual_seed(int(init["seed"])),
            device="cpu"))
    else:
        params = base.init_params(
            specs, torch.Generator(device=dev).manual_seed(int(init["seed"])),
            device=dev)
    if init.get("mla_fan_in"):
        from repro_torch.models.moe import mla_fan_in_init
        mla_fan_in_init(params)
    return params


# ---- checks -----------------------------------------------------------------


class ArenaCheck:
    """Holds the K1 / K2 calls of the arena engine made while ``armed``
    against their plain versions on the same words (bits, and K2's
    per-block counts)."""

    def __init__(self):
        from repro_torch.core import engine
        self.engine = engine
        self.armed = False
        self.checked = 0

    def __enter__(self):
        from repro_torch.kernels.bitflip.bitflip import arena_bitflip_ref
        from repro_torch.kernels.ecc.ecc import arena_ecc_ref
        self.orig = (self.engine.arena_bitflip, self.engine.arena_ecc)

        def wrap(fn, ref, name):
            def run(arena, bb, bt, **kw):
                out = fn(arena, bb, bt, **kw)
                if self.armed:
                    want = ref(arena, bb, bt, **kw)
                    got = out if isinstance(out, tuple) else (out,)
                    want = want if isinstance(want, tuple) else (want,)
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"{name} != its plain version")
                    self.checked += 1
                return out
            return run

        self.engine.arena_bitflip = wrap(self.orig[0], arena_bitflip_ref,
                                         "K1 arena_bitflip")
        self.engine.arena_ecc = wrap(self.orig[1], arena_ecc_ref,
                                     "K2 arena_ecc")
        return self

    def __exit__(self, *exc):
        self.engine.arena_bitflip, self.engine.arena_ecc = self.orig


def close_err(got, ref, atol, rtol) -> float:
    """The largest |got - ref| over finite entries; raises past ``atol +
    rtol |ref|`` or on a different NaN / infinity pattern."""
    a, b = got.float(), ref.float()
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        raise AssertionError("kernel and plain version differ in NaNs")
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(a[~fin].nan_to_num(0.0), b[~fin].nan_to_num(0.0)):
        raise AssertionError("kernel and plain version differ in infinities")
    diff = (a[fin] - b[fin]).abs()
    over = diff > atol + rtol * b[fin].abs()
    if bool(over.any()):
        raise AssertionError(f"{int(over.sum())} finite outputs outside "
                             f"{atol} + {rtol}*|ref| (max abs err "
                             f"{float(diff.max())})")
    return float(diff.max()) if diff.numel() else 0.0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---- runs -------------------------------------------------------------------


def psum_run(run, group, dev) -> Dict[str, Any]:
    """``psum_model`` and ``model_grad_sum`` over a (1, world) mesh: rank
    j's part is seeded ``seed + j``; the loss weights ``w`` and ``x`` are
    seeded alike on every rank."""
    dist = DistContext(mesh=make_rank_mesh(group, (1, group.world)))
    shape, seed = tuple(run["shape"]), int(run["seed"])
    dt = _DTYPES[run.get("dtype", "float32")]
    g = lambda s: torch.randn(shape, generator=torch.Generator().manual_seed(  # noqa: E731
        s)).to(device=dev, dtype=dt)
    j = dist.model_index
    part = g(seed + j).requires_grad_(True)
    y = psum_model([part], dist=dist)
    gp, = torch.autograd.grad((y * g(seed + 100)).sum(), part)
    x = g(seed + 200).requires_grad_(True)
    gx, = torch.autograd.grad((model_grad_sum(x, dist) * g(seed + 300 + j))
                              .sum(), x)
    return {"y": y.detach().float().cpu().tolist(),
            "grad_part": gp.float().cpu().tolist(),
            "grad_x": gx.float().cpu().tolist()}


def train_run(run, group, dev, out_dir: Path, tag: str) -> Dict[str, Any]:
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.data.pipeline import DataConfig, make_rank_batch
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import trainer
    bundle, cfg = model_cfg(run)
    mesh = make_rank_mesh(group, tuple(run["mesh"]))
    dist = DistContext(mesh=mesh)
    dims = state_expert_dims(bundle.module.param_specs(cfg))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if "ckpt" in run["init"]:
        full = trainer.init_state(bundle, cfg,
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
        tmpl = pytree.tree_map(
            lambda t: t.detach().to(dev).requires_grad_(t.requires_grad),
            split_state(full, dims, dist.model_index, dist.model_size))
        del full
        state, _ = ckpt.restore_ranks(run["init"]["ckpt"], tmpl, dist, dims)
    else:
        params = init_model_params(run, bundle, cfg, dev)
        params = split_state({"params": params}, dims, dist.model_index,
                             dist.model_size)["params"]
        for t in pytree.leaves(params):
            t.requires_grad_(True)
        state = {"params": params, "opt": adamw.init(params)}
    tc = trainer.TrainConfig(
        microbatches=int(run.get("microbatches", 1)),
        adamw=AdamWConfig(**run["adamw"]),
        undervolt=plan_from_spec(run.get("plan")))
    step = trainer.make_train_step(bundle, cfg, tc, dist)
    dc = DataConfig(**run["data"])
    if run.get("deterministic"):
        torch.use_deterministic_algorithms(True)
    out: Dict[str, Any] = {"mesh": list(mesh.sizes),
                           "data_index": dist.data_index,
                           "model_index": dist.model_index}
    keys = ("loss", "xent", "router_aux", "grad_norm",
            "corrected_faults", "uncorrectable_faults")
    hist: Dict[str, List[float]] = {k: [] for k in keys}
    split = {"wall_ms": [], "collective_ms": [], "compute_ms": []}
    _build.reset_launch_counts()
    try:
        with ArenaCheck() as check:
            for i in range(int(run["steps"])):
                b = trainer.device_batch(make_rank_batch(
                    dc, i, dist.data_index, dist.data_size,
                    tc.microbatches, cfg), dev)
                check.armed = i == 0
                group.times.clear()
                _sync(dev)
                t0 = time.perf_counter()
                state, m = step(state, b)
                _sync(dev)
                wall = 1e3 * (time.perf_counter() - t0)
                coll = 1e3 * sum(t for _, t in group.times.values())
                split["wall_ms"].append(wall)
                split["collective_ms"].append(coll)
                split["compute_ms"].append(wall - coll)
                for k in keys:
                    if k in m:
                        hist[k].append(float(m[k]))
            out["arena_checked"] = check.checked
    finally:
        if run.get("deterministic"):
            torch.use_deterministic_algorithms(False)
    out.update(hist)
    if run.get("eval_first_batch"):
        # batch 0 again after the steps: whether the loss fell on it
        b0 = trainer.device_batch(make_rank_batch(
            dc, 0, dist.data_index, dist.data_size, tc.microbatches, cfg),
            dev)
        with torch.no_grad():
            loss, _ = bundle.module.forward_train(state["params"], b0, cfg,
                                                  dist)
        if dist.data_size > 1:
            loss = ranks.ordered_sum(group, loss, dist.data_group,
                                     kind="metrics") / dist.data_size
        out["eval_loss_batch0"] = float(loss)
    out["split_ms"] = split
    out["launches"] = dict(_build.launch_counts())
    out["collectives"] = {k: [n, 1e3 * t]
                          for k, (n, t) in group.times.items()}
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["held_bytes"] = sum(t.numel() * t.element_size()
                            for t in pytree.leaves(state))
    if run.get("dump") == "npz":
        host = {pytree.keystr(p): t.detach().to("cpu").float().numpy()
                if t.dtype == torch.bfloat16 else t.detach().to("cpu").numpy()
                for p, t in pytree.flatten_with_path(state)}
        np.savez(out_dir / f"rank{group.rank}_{tag}.npz", **host)
    if run.get("dump") == "digest":
        out["digest"] = {k: [str(a), str(b)]
                         for k, (a, b) in state_digest(state).items()}
    if run.get("samples"):
        np.savez(out_dir / f"rank{group.rank}_{tag}_mu.npz",
                 **leaf_samples(state["opt"]["mu"], int(run["samples"])))
    if run.get("checkpoint"):
        ckpt.save_ranks(run["checkpoint"], int(run["steps"]), state, dist,
                        dims)
    del state, step
    return out


class _K4Probe:
    """Keeps the first eager K4 call of the fleet's decode-only step to
    hold against its plain version, and counts nothing itself."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import faulty
        self.faulty = faulty
        self.call = None

    def __enter__(self):
        self.orig = self.faulty.paged_decode_attention

        def rec(q, *args, **kw):
            if self.call is None and not (
                    q.is_cuda and torch.cuda.is_current_stream_capturing()):
                self.call = ((q.clone(),) + tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args),
                    {k: (tuple(t.clone() for t in v) if isinstance(v, tuple)
                         else v.clone() if torch.is_tensor(v) else v)
                     for k, v in kw.items()})
            return self.orig(q, *args, **kw)

        self.faulty.paged_decode_attention = rec
        return self

    def __exit__(self, *exc):
        self.faulty.paged_decode_attention = self.orig

    def check(self):
        args, kw = self.call
        got = self.orig(*args, **kw)
        ref = self.faulty.paged_decode_attention_ref(*args, **kw)
        return close_err(got, ref, 1e-2, 1e-2)


def _steady_ms(seconds) -> float:
    rest = list(seconds)[2:] or list(seconds)
    return 1e3 * float(np.median(rest)) if rest else float("nan")


def fleet_run(run, group, dev, params_cache) -> Dict[str, Any]:
    from repro_torch.serving.engine import ServeConfig, generate
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request, SelfHealConfig)
    bundle, cfg = model_cfg(run)
    key = json.dumps([run["arch"], run.get("config"), run.get("overrides"),
                      run["init"]], sort_keys=True)
    if key not in params_cache:
        params_cache.clear()
        params_cache[key] = init_model_params(run, bundle, cfg, dev)
    params = params_cache[key]
    plan = plan_from_spec(run.get("plan"))
    gov = None
    if run.get("governor"):
        g = dict(run["governor"])
        gov = plan.make_governor(g.pop("domain", "kv"), **g)
    sc = ServeConfig(undervolt=plan, governor=gov, **run["serve"])
    mesh = make_serve_mesh(int(run["n_shards"]), group=group)
    heal = (SelfHealConfig(**run["self_heal"])
            if run.get("self_heal") is not None else None)
    sched = ContinuousBatchingScheduler(
        bundle, cfg, params, sc, device=dev, mesh=mesh,
        shard_seeds=run.get("shard_seeds"),
        shard_setpoints=run.get("shard_setpoints"), self_heal=heal,
        **run["sched"])
    reqs = run["requests"]
    for rid, toks, n, tier, seed in reqs:
        sched.submit(Request(
            rid=rid, tokens=np.asarray(toks, np.int32), max_new_tokens=n,
            tier=tier, generator=(None if seed is None else torch.Generator(
                device=dev).manual_seed(int(seed)))))
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with _K4Probe() as probe:
        res = sched.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    k4 = _build.launch_counts().get("paged_decode", 0)
    st = sched.stats
    out = {
        "results": {str(rid): {
            "tokens": np.asarray(r.tokens).tolist(), "shard": int(r.shard),
            "page_ids": np.asarray(r.page_ids).tolist(),
            "voltage": None if r.voltage is None else float(r.voltage),
            "ttft_steps": r.ttft_steps, "pages_shared": r.pages_shared}
            for rid, r in res.items()},
        "shards": [{k: v for k, v in row.items()} for row in st["shards"]],
        "pricing": [float(v) for v in sched.pricing_voltages],
        "steps": sched.steps, "decode_traces": st["decode_traces"],
        "k4_launches": k4,
        "k4_per_step": cfg.n_layers * len(sched._local_shards),
        "local_shards": [sh.index for sh in sched._local_shards],
        "decode_step_steady_ms": _steady_ms(sched.step_seconds["decode"]),
        "decode_steps": len(sched.step_seconds["decode"]),
        "mixed_step_ms": 1e3 * float(np.mean(sched.step_seconds["mixed"]))
        if sched.step_seconds["mixed"] else None,
        "exchange_ms": [1e3 * s for s in sched.exchange_seconds],
        "wall_s": wall,
        "tokens": int(sum(np.asarray(r.tokens).size for r in res.values())),
    }
    if heal is not None:
        out["heal"] = {k: st[k] for k in ("corrected", "uncorrectable",
                                          "migrations", "quarantined_pages",
                                          "quarantined_blocks")}
    if probe.call is not None and run.get("k4_check", True):
        out["k4_max_abs_err"] = probe.check()
    # (the CPU runs K4's plain version: no launch to count)
    if dev.type == "cuda" and k4 != out["k4_per_step"] * sched.steps:
        raise AssertionError(f"rank {group.rank}: {k4} K4 launches in "
                             f"{sched.steps} steps, not "
                             f"{out['k4_per_step']} per step")
    # (a governed shard moves its voltage under running requests: no
    # fixed-voltage replay reproduces them)
    if run.get("replay", True) and gov is None:
        mine = {sh.index for sh in sched._local_shards}
        checked = []
        for rid, toks, n, tier, seed in reqs:
            r = res[rid]
            if r.shard not in mine:
                continue
            ref = generate(bundle, cfg, params,
                           {"tokens": torch.as_tensor(
                               np.asarray(toks, np.int64))[None]},
                           dataclasses.replace(
                               sc, max_new_tokens=n,
                               undervolt=sched.shard_plan(r.shard)),
                           device=dev, kv_placement=r.placement,
                           generator=(None if seed is None else
                                      torch.Generator(device=dev)
                                      .manual_seed(int(seed))))
            if not np.array_equal(ref.cpu().numpy(), r.tokens):
                raise AssertionError(f"rank {group.rank}: request {rid} "
                                     f"(shard {r.shard}) != its solo replay")
            checked.append(str(rid))
        out["replayed"] = checked
    if run.get("trace") and dev.type == "cuda":
        out["trace"] = trace_fleet_steps(run, bundle, cfg, params, sc, mesh,
                                         dev)
    del sched
    return out


def trace_fleet_steps(run, bundle, cfg, params, sc, mesh, dev):
    """A short decode-only stream of the run's traffic, rank 0's run under
    torch.profiler: the captured decode steps 3 and 4 (each from its graph
    launch to the last device op started before the next launch); the
    device-busy share of their window (the union of rank 0's device
    intervals over the steps' wall time)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               Request)
    t = dict(run["trace"])
    sched = ContinuousBatchingScheduler(
        bundle, cfg, params, dataclasses.replace(
            sc, governor=None, undervolt=plan_from_spec(t["plan"]),
            kv_injection=t["mode"], kv_method="auto",
            prefill_chunk=int(t["prompt"])),
        device=dev, mesh=mesh, **run["sched"])
    for rid, toks, _, tier, _ in run["requests"][:run["sched"]["num_slots"]]:
        sched.submit(Request(rid=rid, tokens=np.asarray(
            toks[:int(t["prompt"])], np.int32), max_new_tokens=int(t["new"]),
            tier=tier))
    if mesh.group.rank != 0:          # the other ranks serve untraced
        sched.run()
        return None
    path = Path(tempfile.mkdtemp()) / "trace.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sched.run()
        torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    # decode step 0 runs eager, step 1 captures and launches the graph:
    # graph launch k is decode step k + 1
    launches = sorted(float(e["ts"]) for e in events if e.get("ph") == "X"
                      and str(e.get("name", "")).startswith(
                          "cudaGraphLaunch"))
    if len(launches) < 4:
        raise AssertionError(f"rank 0's trace holds {len(launches)} graph "
                             "launches: too few decode steps to trace")
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in events if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    window = busy = 0.0
    n_ops = 0
    steps = launches[2:4]
    for i, a in enumerate(steps):
        nxt = launches[i + 3] if i + 3 < len(launches) else float("inf")
        inside = [o for o in ops if a <= o[0] < nxt]
        window += max([a] + [o[1] for o in inside]) - a
        end = a
        for x, y in inside:
            busy += max(0.0, y - max(x, end))
            end = max(end, y)
        n_ops += len(inside)
    return {"steps": len(steps), "window_ms": window / 1e3 / len(steps),
            "busy_ms": busy / 1e3 / len(steps),
            "idle_share": (1.0 - busy / window) if n_ops and window else None,
            "device_ops_per_step": n_ops / len(steps)}


# ---- entry ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spec", required=True, help="the runs (JSON file)")
    ap.add_argument("--out", required=True, help="directory for results")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch intra-op threads (0: torch's default)")
    ranks.add_rank_args(ap)
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    spec = json.loads(Path(args.spec).read_text())
    # deterministic runs need cuBLAS's workspace fixed before its first
    # handle; TF32 stays off, as on the logical mesh
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    devices = spec.get("devices") or ranks.rank_devices(
        args.world, spec.get("device", "cuda"))
    group = ranks.init_ranks(addr=args.addr, port=args.port,
                             world=args.world, rank=args.rank,
                             devices=devices)
    dev = group.device
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    results: Dict[str, Any] = {"rank": group.rank, "world": group.world,
                               "device": str(dev), "backend": group.backend,
                               "layout": group.describe, "runs": {}}
    params_cache: Dict[str, Any] = {}
    try:
        for i, run in enumerate(spec["runs"]):
            tag = run.get("name", f"run{i}")
            t0 = time.perf_counter()
            if run["kind"] == "psum":
                r = psum_run(run, group, dev)
            elif run["kind"] == "train":
                params_cache.clear()
                r = train_run(run, group, dev, out_dir, tag)
            elif run["kind"] == "fleet":
                r = fleet_run(run, group, dev, params_cache)
            else:
                raise ValueError(f"unknown run kind {run['kind']!r}")
            r["seconds"] = time.perf_counter() - t0
            results["runs"][tag] = r
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            group.barrier()
        (out_dir / f"rank{group.rank}.json").write_text(
            json.dumps(results, default=float))
    finally:
        ranks.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
