"""Plain PyTorch version of the RG-LRU scan kernel K8 (port of
:mod:`repro.kernels.rglru.ref`): the seeded linear recurrence
h_t = a_t * h_{t-1} + b_t, walked step by step."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, b, h0):
    """a, b: (B, S, R); h0: (B, R) -> (h_seq (B, S, R), h_last (B, R)),
    float32.  h0 enters at step 0 as a_0 * h0 + b_0 (the reference folds
    it into its first element); the reference's associative scan sums in
    another order."""
    a = a.float()
    b = b.float()
    h = h0.float()
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, out[:, -1].clone()
