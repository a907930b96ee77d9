"""Plain PyTorch versions of the RG-LRU scan kernel K8 (port of
:mod:`repro.kernels.rglru.ref`): the seeded linear recurrence
h_t = a_t * h_{t-1} + b_t, walked step by step, and the model's RG-LRU
(its gate math, then that walk), which K8's gated variant fuses."""
from __future__ import annotations

import torch
import torch.nn.functional as F

RGLRU_C = 8.0  # the Griffin paper's fixed recurrence sharpness constant


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


def rglru_gates_ref(r_g, i_g, y, lam):
    """The RG-LRU's (a, b) from its gates r_g, i_g (B, S, R) float32, its
    input y (B, S, R) and lam (R,): a = exp(-C softplus(lam) r_g),
    b = sqrt(max(1 - a^2, 1e-12)) * (i_g * y), float32, op by op."""
    log_a = -RGLRU_C * F.softplus(lam) * r_g
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                       1e-12)) * (i_g * y.float())
    return a, gated


def rglru_gated_scan_ref(r_g, i_g, y, lam, h0):
    """The RG-LRU over a sequence: :func:`rglru_gates_ref`, then
    :func:`rglru_scan_ref` from h0."""
    return rglru_scan_ref(*rglru_gates_ref(r_g, i_g, y, lam), h0)
