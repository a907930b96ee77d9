"""Counter-based integer hashing shared by the fault-injection paths.

Port of :mod:`repro.core.hashing`.  Every location gets a deterministic
uniform value ``u = hash(seed, location)`` and is stuck iff ``u < q(v)``.

Representation: uint32 words travel through the port as ``torch.int32``
bit patterns (what a CUDA kernel sees as ``uint32_t``).  PyTorch on the
CPU has no uint32 shifts, compares, negation or ``arange``, so the plain
versions do their arithmetic on ``torch.int64`` tensors holding the
unsigned value (``0 <= x < 2**32``) and mask with ``& 0xFFFFFFFF``;
:func:`as_u64` and :func:`as_i32` convert between the two forms.  The
CUDA kernels compute the same functions in ``csrc/fault_masks.cuh``.
"""
from __future__ import annotations

import math

import torch

# Distinct stream constants so each use-site draws independent values.
STREAM_WORD_01 = 0x9E3779B1   # word-level stuck-at-1 draw
STREAM_WORD_10 = 0x85EBCA77   # word-level stuck-at-0 draw
STREAM_BITPOS_01 = 0xC2B2AE3D
STREAM_BITPOS_10 = 0x27D4EB2F
STREAM_ROW = 0x165667B1       # weak-row selection
STREAM_BITPLANE = 0xD3A2646C  # bitwise-path plane seeds

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
MASK = 0xFFFFFFFF

# Bit-planes in the bitwise injection path: probability resolution
# 2**-PLANES.
PLANES = 20


def as_u64(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or int64 values) -> int64 unsigned values."""
    return x.to(torch.int64) & MASK


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 unsigned values -> int32 bit patterns (two's complement)."""
    x = x & MASK
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for int64 ``x < 2**32`` without overflowing
    int64: the multiplier is split into 16-bit halves."""
    lo = x * (m & 0xFFFF)
    hi = (x * (m >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3/splitmix-style 32-bit finalizer on int64 unsigned values."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    x = x ^ (x >> 16)
    return x


def mix32_int(x: int) -> int:
    """Pure-Python mix32 for seed folding."""
    x &= MASK
    x ^= x >> 16
    x = (x * _M1) & MASK
    x ^= x >> 15
    x = (x * _M2) & MASK
    x ^= x >> 16
    return x


def hash_stream(seed: int, stream: int, counter: torch.Tensor) -> torch.Tensor:
    """Deterministic uniform uint32 (as int64) per (seed, stream, counter).

    ``counter`` holds int64 unsigned values."""
    inner = mix32_int(int(seed) ^ int(stream))
    return mix32(counter ^ inner)


def rate_to_u32_threshold(rate: float) -> int:
    """Probability in [0,1] -> uint32 compare threshold (u < t <=> hit)."""
    rate = min(1.0, max(0.0, float(rate)))
    return min(0xFFFFFFFF, int(math.floor(rate * 4294967296.0)))


def rate_to_u32_threshold_t(rate: torch.Tensor) -> torch.Tensor:
    """float32 probabilities -> uint32 thresholds as int64 values; a rate
    that rounds to 1.0 in float32 saturates to 0xFFFFFFFF."""
    t = torch.floor(torch.clamp(rate.to(torch.float32), 0.0, 1.0)
                    * torch.tensor(4294967296.0, dtype=torch.float32))
    return torch.where(t >= 4294967296.0, torch.tensor(MASK),
                       t.to(torch.int64))


def rate_to_plane_threshold_t(rate: torch.Tensor) -> torch.Tensor:
    """Probability -> PLANES-bit integer threshold for the bitwise path,
    round(p * 2**PLANES) clipped to 2**PLANES - 1 (int64 values)."""
    t = torch.round(rate.to(torch.float32)
                    * torch.tensor(float(2 ** PLANES), dtype=torch.float32))
    return torch.clamp(t, 0.0, float(2 ** PLANES - 1)).to(torch.int64)
