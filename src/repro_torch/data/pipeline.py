"""Deterministic synthetic data pipeline (port of
:mod:`repro.data.pipeline`, numpy on the host like the reference's).

Seeded by (seed, step, host shard), so every host makes its own disjoint
slice of the global batch with no coordination, and a restart at step k
makes the same stream again.  The seeds and the generation loop are the
reference's, so a batch equals the reference's bit for bit.

Sequences are Markov-structured (each token limits its successors to a
small seeded set), so language models can learn them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.models.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branching: int = 4          # successors per token (entropy knob)
    host_count: int = 1
    host_index: int = 0


def _transition_table(cfg: DataConfig) -> np.ndarray:
    rng = np.random.RandomState(cfg.seed ^ 0xBEEF)
    return rng.randint(0, cfg.vocab,
                       size=(cfg.vocab, cfg.branching)).astype(np.int32)


def make_batch(cfg: DataConfig, step: int,
               arch: Optional[ArchConfig] = None) -> Dict[str, np.ndarray]:
    """The host's shard of global batch ``step`` (numpy arrays)."""
    if cfg.global_batch % cfg.host_count:
        raise ValueError(f"global_batch {cfg.global_batch} does not split "
                         f"over {cfg.host_count} hosts")
    local = cfg.global_batch // cfg.host_count
    rng = np.random.RandomState(
        (cfg.seed * 1_000_003 + step * 7919 + cfg.host_index) % (2**31))
    table = _transition_table(cfg)
    tokens = np.empty((local, cfg.seq_len), np.int32)
    tokens[:, 0] = rng.randint(0, cfg.vocab, local)
    choices = rng.randint(0, cfg.branching, size=(local, cfg.seq_len))
    for t in range(1, cfg.seq_len):
        tokens[:, t] = table[tokens[:, t - 1], choices[:, t]]
    out = {"tokens": tokens}
    if arch is not None and arch.family == "vlm":
        out["patches"] = rng.randn(
            local, arch.enc_len, arch.frontend_dim).astype(np.float32)
    if arch is not None and arch.family == "audio":
        out["frames"] = rng.randn(
            local, arch.enc_len, arch.d_model).astype(np.float32)
    return out


def batch_iterator(cfg: DataConfig, start_step: int = 0,
                   arch: Optional[ArchConfig] = None):
    step = start_step
    while True:
        yield step, make_batch(cfg, step, arch)
        step += 1
