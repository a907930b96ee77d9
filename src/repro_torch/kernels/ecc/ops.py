"""Per-segment inject+ECC entry point (port of :mod:`repro.kernels.ecc.ops`)."""
from __future__ import annotations

import torch

from repro_torch.kernels.ecc import ref as _ref
from repro_torch.kernels.ecc.ecc import segment_ecc


def inject_and_correct_u32(data_u32: torch.Tensor, *, thresholds, seed: int,
                           base_word: int = 0, use_ref: bool = False):
    """Apply stuck-at faults + SECDED correction to a flat int32 run of
    physical words ``[base_word, base_word + n)``.

    Returns (corrected words, uncorrectable codeword count as a 0-d int64
    tensor on the run's device).  The two routes count the tail as the
    reference's two routes do: the default route (one K6 launch, or its
    plain version on the CPU) counts every codeword of the run zero-padded
    to whole 4096-word blocks; ``use_ref`` pads only to an even length.
    On an unaligned run the two can therefore differ."""
    n = data_u32.shape[0]
    if use_ref:
        padded = (torch.cat([data_u32, data_u32.new_zeros(1)]) if n % 2
                  else data_u32)
        out, bad = _ref.inject_and_correct_u32_ref(
            padded, thresholds=thresholds, seed=int(seed),
            base_word=int(base_word))
        return out[:n], bad
    out, bad = segment_ecc(data_u32, thresholds=thresholds, seed=int(seed),
                           base_word=int(base_word))
    return out, bad.sum(dtype=torch.int64)
