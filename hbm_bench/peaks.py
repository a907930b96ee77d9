"""The yardstick's peaks and work counts.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W limit).  Integer and logic operations are bounded by the
instruction rate: an SM executes at most 128 lane operations a clock,
the float32 lane rate, 67e12 / 2 (the data sheet counts a fused
multiply-add as two).

Work is counted from the published shapes of the configuration, never
from what a program happens to launch: model FLOPs of every position a
step processes (matrix products with the layer's weights, attention over
the live context, the output head for every sampled token), and the
bytes a decode step must move (every weight once, the K/V of the live
positions once).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
INT_OPS_PER_S = 67e12 / 2

# Integer operations per 32-bit word of the SECDED read path, counted
# from the mask arithmetic (reference/faults.py): the word masks' five
# hashes and selects, two popcounts, the weak-row and parity hashes
# (78), and the word's address in its page (6).
ECC_OPS_PER_WORD = 78 + 6


def bound_s(bytes_moved: float, int_ops: float = 0.0,
            bf16_flops: float = 0.0) -> float:
    """Least seconds the card could take: the larger of the bytes over
    the HBM rate and the operations over their peak rates."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = int_ops / INT_OPS_PER_S + bf16_flops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops)


def dense_layer_params(cfg: dict) -> int:
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    q = cfg["num_attention_heads"] * hd
    kv = cfg["num_key_value_heads"] * hd
    return d * q * 2 + d * kv * 2 + 3 * d * cfg["intermediate_size"]


def position_work(cfg: dict):
    """(FLOPs of one position's weight products through every layer,
    FLOPs of attention per key it attends over every layer), 2 FLOPs a
    multiply-add."""
    layers = cfg["num_hidden_layers"]
    return (2.0 * layers * dense_layer_params(cfg),
            4.0 * layers * cfg["num_attention_heads"] * cfg["head_dim"])


def head_flops(cfg: dict) -> float:
    return 2.0 * cfg["vocab_size"] * cfg["hidden_size"]


def kv_bytes_per_position(cfg: dict) -> int:
    """K and V of one position in every layer, bf16."""
    return (2 * cfg["num_key_value_heads"] * cfg["head_dim"] * 2
            * cfg["num_hidden_layers"])


def weight_bytes(cfg: dict) -> int:
    """Every weight a decode step reads, bf16 (the embedding table gives
    one row a token and is left out)."""
    return 2 * (cfg["num_hidden_layers"] * dense_layer_params(cfg)
                + cfg["vocab_size"] * cfg["hidden_size"])


def k4_launch_bound_s(cfg: dict, ctx_lengths) -> float:
    """Least seconds of one layer's paged decode attention over decode
    lanes whose live contexts are ``ctx_lengths``: their K/V read once,
    each word through the SECDED round, the bf16 attention products."""
    kh, hd, h = (cfg["num_key_value_heads"], cfg["head_dim"],
                 cfg["num_attention_heads"])
    live = sum(ctx_lengths)
    words = live * 2 * kh * hd // 2
    io = 4 * words + len(ctx_lengths) * 2 * 2 * h * hd
    return bound_s(io, int_ops=words * ECC_OPS_PER_WORD,
                   bf16_flops=4.0 * h * hd * live)
