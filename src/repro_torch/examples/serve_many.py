"""Serving at scale: a mixed-tier request stream with a shared system
prompt through the continuous-batching scheduler -- on one device or
sharded across a heterogeneous-voltage fleet (the port's counterpart of
the reference's ``examples/serve_many.py``).

A stream of requests with different prompts, generation lengths and
criticality tiers is pushed through one scheduler: strict-tier requests
get weak-row-free pages, tolerant requests soak up the weak pages first,
the admission governor walks the KV-domain voltage along the
power/reliability frontier as load changes, and every decode-only step
replays ONE captured graph (watch ``decode_traces`` stay 1).  Half the
stream opens with the same system prompt: later tenants map the cached
prefix pages read-only (copy-on-write) instead of recomputing them.

With ``--devices N`` the scheduler shards over an N-way serve mesh, one
shard per rank: N processes (``torch.distributed``, one card each when
there are N cards, else sharing one), each holding its own shard's pool
and captured step, every shard drawing its OWN fault map and admitting
against its own governor setpoint, so the fleet runs heterogeneous
voltages.  Every rank runs the whole fleet's host loop and the ranks
exchange their sampled tokens after each step, so all agree on every
decision; rank 0 prints.  ``--logical`` serves the same N shards as
logical shards in one process (the yardstick).

With ``--chaos`` the stream runs on an ECC'd worst-channel domain and a
live DRAM row is flipped weak mid-stream: the scrub's SECDED counts feed
the fault-map posterior, the accused row's pages migrate inside the
decode step and the row is quarantined.

With ``--arch NAME`` the stream runs any registered architecture through
the SAME scheduler front door (paged families, or the state arena for
MoE, recurrent hybrids, xLSTM, whisper and the VLM), and one request is
replayed alone through ``generate()`` on its placement, bit for bit.

  PYTHONPATH=src python -m repro_torch.examples.serve_many [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.serve_many --devices 2
  PYTHONPATH=src python -m repro_torch.examples.serve_many --chaos
  PYTHONPATH=src python -m repro_torch.examples.serve_many --arch whisper-large-v3
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.domains import MemoryDomain
from repro_torch.core.hbm import VCU128
from repro_torch.launch import ranks
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models.base import get_arch, init_params
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           Request, SelfHealConfig)
from repro_torch.training.undervolt import UndervoltPlan

RANK_TIMEOUT_S = 900


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="serve-mesh shard count: one rank process per "
                    "shard")
    ap.add_argument("--logical", action="store_true",
                    help="serve the --devices shards as logical shards in "
                    "this one process")
    ap.add_argument("--chaos", action="store_true",
                    help="flip a live DRAM row weak mid-stream and watch "
                    "the self-healing loop detect it, migrate its pages "
                    "and quarantine the row")
    ap.add_argument("--arch", default=None,
                    help="serve this registered architecture instead of "
                    "the llama3.2-3b stream (single shard)")
    ap.add_argument("--metrics", action="store_true",
                    help="print the observability plane after the drain")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ranks.add_rank_args(ap)
    return ap.parse_args(argv)


def _params(bundle, cfg, dev):
    return init_params(bundle.module.param_specs(cfg),
                       torch.Generator(device=dev).manual_seed(0),
                       device=dev)


def zoo_main(args, dev) -> None:
    """Any-family lane: ``--arch`` through the one scheduler front door;
    one request replayed alone, bit for bit."""
    if args.devices > 1 or args.chaos:
        raise SystemExit("--arch is a single-shard lane; drop "
                         "--devices/--chaos")
    bundle = get_arch(args.arch)
    cfg = bundle.reduced
    params = _params(bundle, cfg, dev)
    plan = UndervoltPlan(
        domains={"kv": MemoryDomain("kv", 0.90,
                                    tuple(range(VCU128.num_pcs)))},
        policy={"kv_cache": "kv"}, geometry=VCU128)
    sc = ServeConfig(max_len=32, max_new_tokens=6, undervolt=plan,
                     kv_injection="write", kv_method="bitwise")
    sched = ContinuousBatchingScheduler(
        bundle, cfg, params, sc, num_slots=2, num_pages=16, page_slots=8,
        device=dev)
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(3):
        extras = None
        if cfg.family == "audio":
            extras = {"frames": rng.standard_normal(
                (cfg.enc_len, cfg.d_model)).astype(np.float32)}
        elif cfg.family == "vlm":
            extras = {"patches": rng.standard_normal(
                (cfg.enc_len, cfg.frontend_dim)).astype(np.float32)}
        reqs.append((rng.randint(0, cfg.vocab, (4 + 2 * i,)), 3 + i,
                     extras))
        sched.submit(Request(
            rid=f"req{i}", tokens=reqs[-1][0], max_new_tokens=3 + i,
            generator=torch.Generator(device=dev).manual_seed(7 * i),
            extras=extras))
    results = sched.run()
    st = sched.stats
    print(f"{args.arch} [{cfg.family}] route={st['route']} "
          f"layouts={sorted(set(st['cache_layouts']))} "
          f"steps={st['steps']} decode_traces={st['decode_traces']}")
    for i in range(3):
        r = results[f"req{i}"]
        print(f"req{i} v={r.voltage:.2f} tokens={r.tokens[0].tolist()}")
    assert st["decode_traces"] == 1, st
    toks, n_new, extras = reqs[1]
    batch = {"tokens": torch.from_numpy(toks.astype(np.int64))[None]}
    for k, v in (extras or {}).items():
        batch[k] = torch.from_numpy(v)[None]
    solo = generate(bundle, cfg, params, batch,
                    dataclasses.replace(sc, max_new_tokens=n_new),
                    device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7),
                    kv_placement=results["req1"].placement)
    np.testing.assert_array_equal(solo.cpu().numpy(), results["req1"].tokens)
    print("solo replay: bit-identical")


def fleet_main(args, dev, group=None) -> None:
    """The llama3.2-3b stream over ``args.devices`` shards: logical ones
    in this process, or this rank's of ``group``."""
    say = print if group is None or group.rank == 0 else (
        lambda *a, **k: None)
    n_shards = args.devices
    bundle = get_arch("llama3.2-3b")
    cfg = bundle.reduced
    params = _params(bundle, cfg, dev)
    mesh = None
    if n_shards > 1:
        mesh = (make_serve_mesh(n_shards, devices=[dev] * n_shards)
                if group is None else make_serve_mesh(n_shards, group=group))
    kw = {}
    if args.chaos:
        # an ECC'd domain on the four least-reliable pseudo-channels, where
        # a weak row at 0.91 V throws correctable SECDED events on every
        # read -- the telemetry the healing loop feeds on
        plan = UndervoltPlan(
            domains={"kv": MemoryDomain("kv", 0.91, (8, 15, 18, 29),
                                        ecc=True)},
            policy={"kv_cache": "kv"}, geometry=VCU128)
        sc = ServeConfig(max_len=64, max_new_tokens=8, undervolt=plan,
                         kv_injection="read", kv_method="word",
                         prefill_chunk=8, share_prefix=True)
        kw["self_heal"] = SelfHealConfig()
        if mesh is not None:
            kw["mesh"] = mesh
    else:
        plan = UndervoltPlan(
            domains={"kv": MemoryDomain("kv", 0.90,
                                        tuple(range(VCU128.num_pcs)))},
            policy={"kv_cache": "kv"}, geometry=VCU128)
        governor = plan.make_governor("kv", mode="rate",
                                      tolerable_rate=1e-3, v_lo=0.87)
        sc = ServeConfig(max_len=64, max_new_tokens=8, undervolt=plan,
                         governor=governor, kv_injection="read",
                         kv_method="bitwise", prefill_chunk=8,
                         share_prefix=True)
        if mesh is not None:
            # heterogeneous rate setpoints: shard 0 the strict end of the
            # fleet (shallow undervolt), the last shard the tolerant end
            kw = dict(mesh=mesh, shard_setpoints=list(
                np.geomspace(1e-9, 1e-4, n_shards)))
    sched = ContinuousBatchingScheduler(
        bundle, cfg, params, sc, num_slots=4 * n_shards,
        num_pages=40 * n_shards, page_slots=8, device=dev, **kw)

    rng = np.random.RandomState(0)
    system = rng.randint(0, cfg.vocab, (19,))   # shared system prompt
    tiers = ["cheap", "critical", "cheap", "hedged", "cheap", "cheap",
             "critical", "cheap"] * n_shards
    where = ("" if group is None else
             f" on {group.world} ranks ({group.describe})")
    say(f"fleet: {sched.stats['n_shards']} shard(s){where}, "
        f"{sched.stats['free_pages']} pages total, "
        f"{sched.pool.n_logical_pages} pages/request")
    for i, tier in enumerate(tiers):
        user = rng.randint(0, cfg.vocab, (4 + i % 8,))
        toks = np.concatenate([system, user]) if i % 2 else user
        sched.submit(Request(
            rid=f"req{i}", tokens=toks, max_new_tokens=4 + 2 * (i % 3),
            tier=tier,
            generator=torch.Generator(device=dev).manual_seed(i)))

    if args.chaos:
        # drain by hand so the chaos hook fires mid-stream: after two
        # steps, the DRAM row under shard 0's oldest live page goes weak
        weakened, step_i = None, 0
        while sched.queue or sched.n_active:
            sched.admit_pending()
            if not sched.n_active:
                break
            if weakened is None and step_i == 2:
                pool0 = sched._shards[0].pool
                pc, row = pool0.page_rows(sorted(pool0._owned)[0])[0]
                pids = sched.weaken_row(0, pc, row)
                weakened = (pc, row)
                say(f"CHAOS @step {step_i}: pc{pc} row {row} went weak "
                    f"({len(pids)} live pages affected)")
            sched.step_once()
            step_i += 1
        results = sched.results
    else:
        results = sched.run()
    for i, tier in enumerate(tiers):
        r = results[f"req{i}"]
        pool_k = sched._shards[r.shard].pool
        weak = sum(1 for p in r.page_ids if int(p) in pool_k._weak_set)
        say(f"req{i:<2d} [{tier:8s}] shard={r.shard} v={r.voltage:.2f} "
            f"({weak} weak, {r.pages_shared} shared) ttft={r.ttft_steps} "
            f"tokens={r.tokens[0].tolist()}")
    st = sched.stats
    for sh in st["shards"]:
        sp = "-" if sh["setpoint"] is None else f"{sh['setpoint']:.1e}"
        say(f"shard {sh['shard']}: seed={sh['map_seed']} setpoint={sp} "
            f"v={sh['voltage']:.2f} weak_pages={sh['weak_pages']} "
            f"free_pages={sh['free_pages']}")
    if "fleet" in st:
        fl = st["fleet"]
        say(f"fleet: power_factor mean={fl['power_factor_mean']:.3f} "
            f"max={fl['power_factor_max']:.3f} "
            f"worst_rate={fl.get('worst_rate', 0):.2e}")
    if args.chaos:
        sh0 = st["shards"][0]
        say(f"self-heal: corrected={st['corrected']} "
            f"uncorrectable={st['uncorrectable']} "
            f"suspect_rows={sh0['suspect_rows']} "
            f"migrations={st['migrations']} "
            f"quarantined_pages={st['quarantined_pages']} "
            f"quarantined_blocks={st['quarantined_blocks']}")
        assert st["corrected"] > 0, "chaos row never produced telemetry"
        assert st["uncorrectable"] == 0, st
        assert st["migrations"] >= 1 and st["quarantined_pages"] >= 1, st
    assert st["decode_traces"] == 1
    shared = [results[f"req{i}"].pages_shared
              for i in range(len(tiers)) if i % 2]
    if not args.chaos:
        # (under --chaos the deep worst-PC domain keeps the prefix cache
        # from publishing, so sharing is legitimately absent)
        assert any(s > 0 for s in shared[1:]), shared
    if n_shards > 1 and not args.chaos:
        vs = [sh["voltage"] for sh in st["shards"]]
        assert len(set(f"{v:.3f}" for v in vs)) > 1, (
            f"expected heterogeneous shard voltages, got {vs}")
        assert vs[0] >= vs[-1], vs   # strict shard runs shallower
    if group is not None:
        ex = sched.exchange_seconds
        say(f"ranks: {len(ex)} control-plane exchanges, "
            f"{1e3 * float(np.median(ex)):.3f} ms median per step")

    if args.metrics:
        from repro_torch.obs import export
        say("\n---- prometheus exposition " + "-" * 38)
        say(export.prometheus_text(sched), end="")
        say("---- event trace (JSONL tail) " + "-" * 35)
        for ev in sched.trace.events()[-8:]:
            say(json.dumps(ev.to_dict()))
        # the in-step counters against what the drain provably did: every
        # request spends n_new - 1 decode steps and consumes its prompt
        tot = st["obs"]["totals"]
        want_dec = sum(r.tokens.shape[1] - 1 for r in results.values())
        assert tot["tokens_decoded"] == want_dec, (tot, want_dec)
        assert tot["kv_bytes_moved"] > 0
        assert st["obs"]["step_latency"]["count"] == st["steps"]
        en = st["obs"]["energy"]
        assert en["tokens"] == tot["tokens_decoded"]
        assert en["joules_per_token"] > 0
        assert st["events"]["admission"] == len(results)
        assert st["events"]["retirement"] == len(results)
        say(f"metrics OK: {tot['tokens_decoded']} tokens, "
            f"{tot['kv_bytes_moved']} KV bytes, "
            f"{en['joules_per_token']:.3f} J/token "
            f"(${en['usd_per_mtok']:.2f}/Mtok)")


def main(argv=None) -> None:
    args = _parse(argv)
    dev = resolve_device(args.device)
    if args.arch is not None:
        zoo_main(args, dev)
    elif args.devices > 1 and not args.logical and not args.port:
        # the parent: one rank process per shard; rank 0 reports
        fwd = ["--devices", str(args.devices), "--device", args.device]
        fwd += ["--chaos"] * args.chaos + ["--metrics"] * args.metrics
        outs = ranks.launch("repro_torch.examples.serve_many", args.devices,
                            fwd, timeout_s=RANK_TIMEOUT_S)
        print(outs[0], end="")
    elif args.port:
        group = ranks.init_ranks(
            addr=args.addr, port=args.port, world=args.world, rank=args.rank,
            devices=ranks.rank_devices(args.world, dev))
        try:
            fleet_main(args, group.device, group)
        finally:
            ranks.shutdown()
    else:
        fleet_main(args, dev)


if __name__ == "__main__":
    main()
