"""The system under test for a paged-serving cell: the port's continuous-
batching scheduler over its reliability-aware paged KV cache, built from
a configuration file and a traffic mix and handed the harness's weights.

Only the system under test (this module) and :mod:`hbm_bench.run` import
the program (``repro_torch``); the reference never does.
"""
from __future__ import annotations

import torch

from hbm_bench import weights as W
from hbm_bench.reference import faults as F


def arch_config(cfg: dict):
    """The program's ArchConfig for a dense configuration file."""
    from repro_torch.models.base import ArchConfig
    return ArchConfig(
        arch_id=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        dtype=torch.bfloat16)


def program_params(cfg: dict, seed: int, device):
    """The harness's weights in the program's parameter tree: each layer
    drawn once and copied into its slice of the stacked leaves."""
    layers = cfg["num_hidden_layers"]
    d = cfg["hidden_size"]
    stacked = {}
    for layer in range(layers):
        p = W.layer(cfg, seed, layer, device)
        for name, w in p.items():
            if name not in stacked:
                stacked[name] = torch.empty((layers,) + tuple(w.shape),
                                            dtype=W.DTYPE, device=device)
            stacked[name][layer].copy_(w)
        del p
    for norm in ("ln1", "ln2"):
        stacked[norm] = torch.zeros((layers, d), dtype=W.DTYPE, device=device)
    return {"embed": W.dense_head(cfg, seed, "embed", device),
            "unembed": W.dense_head(cfg, seed, "unembed", device),
            "stack": {"prefix": {}, "periods": {"s0_global": stacked},
                      "rest": {}},
            "ln_f": torch.zeros((d,), dtype=W.DTYPE, device=device)}


def kv_pcs(cfg: dict):
    dep = cfg["deployment"]
    return F.FaultMap(dep["map_seed"]).usable_pcs(dep["kv_voltage"],
                                                  dep["kv_pcs"])


def build(cfg: dict, mix, params, device):
    """The scheduler of one cell: ``mix.clients`` slots, a pool of pages
    for every slot's whole ring, the KV cache in a SECDED domain at the
    configured voltage over the configured number of most reliable PCs,
    read-path injection, greedy sampling."""
    from repro_torch.core.domains import MemoryDomain
    from repro_torch.core.hbm import VCU128
    from repro_torch.models.base import get_arch
    from repro_torch.serving.engine import ServeConfig
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    from repro_torch.training.undervolt import UndervoltPlan
    import dataclasses
    dep = cfg["deployment"]
    plan = UndervoltPlan(
        domains={"kv": MemoryDomain("kv", dep["kv_voltage"],
                                    kv_pcs(cfg), ecc=dep["kv_ecc"])},
        policy={"kv_cache": "kv"}, geometry=VCU128,
        map_seed=dep["map_seed"])
    sc = ServeConfig(max_len=mix.max_len, max_new_tokens=1,
                     temperature=0.0, undervolt=plan, kv_method="word",
                     kv_injection=dep["kv_injection"],
                     prefill_chunk=mix.prefill_chunk, share_prefix=False)
    bundle = dataclasses.replace(get_arch(cfg["program_arch"]),
                                 cfg=arch_config(cfg))
    pages = mix.clients * (mix.max_len // mix.page_slots)
    return ContinuousBatchingScheduler(
        bundle, bundle.cfg, params, sc, num_slots=mix.clients,
        num_pages=pages, page_slots=mix.page_slots, device=device)


def request(rid, tokens, n_new, tier):
    from repro_torch.serving.scheduler import Request
    return Request(rid=rid, tokens=tokens, max_new_tokens=n_new, tier=tier)


def prefill_tokens(sched) -> int:
    """The scheduler's own count of prompt tokens consumed so far."""
    from repro_torch.obs.metrics import STEP_COUNTERS
    col = STEP_COUNTERS.index("prefill_tokens")
    return int(sched.state["mtr"][:, col].sum())


def num_pages(mix) -> int:
    return mix.clients * (mix.max_len // mix.page_slots)


def free_pages(sched) -> int:
    return int(sched.pool.free_pages)


def placement(cfg: dict, mix, finished: dict):
    """Where a request's K/V lived, for the reference: its pages (the
    scheduler's choice, read from its result) in the pool this module
    builds, whose leaves the domain places (worked out again there)."""
    from hbm_bench.reference.dense import PagedKV
    dep = cfg["deployment"]
    return PagedKV(page_ids=tuple(finished["page_ids"]),
                   total_pages=num_pages(mix) + 1,
                   page_slots=mix.page_slots, max_len=mix.max_len,
                   map_seed=dep["map_seed"], voltage=dep["kv_voltage"],
                   pcs=kv_pcs(cfg))
