"""Take the reference package's params, caches and train states into the
port.

The reference hands over numpy trees (``numpy.asarray`` of its arrays);
nothing here imports JAX.  bf16 arrays arrive as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses, so they travel as their raw 16-bit
words (``.view(np.uint16)`` -> ``torch.int16`` -> ``.view(torch.bfloat16)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pytree

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy array (any dtype the reference uses) -> torch tensor of
    the same shape, bit for bit."""
    shape = np.shape(a)
    return _tensor_from_numpy(np.ascontiguousarray(a), device).reshape(shape)


def _tensor_from_numpy(a, device):
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).to(device)
    if a.dtype not in _NP_TO_TORCH:
        raise TypeError(f"no torch counterpart for numpy dtype {a.dtype}")
    return torch.from_numpy(a.copy()).to(device)


def tensor_to_numpy_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's raw bits as an unsigned numpy array (uint8/16/32)."""
    size = t.element_size()
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[size]
    raw = t.detach().cpu().contiguous().view(view).numpy()
    return raw.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[size])


def params_from_jax(numpy_tree, device="cpu"):
    """The reference's parameter tree (numpy leaves) as torch tensors."""
    return pytree.tree_map(lambda a: tensor_from_numpy(a, device),
                           numpy_tree)


# A cache tree converts leaf by leaf exactly like a parameter tree.
cache_from_jax = params_from_jax


def train_state_from_jax(numpy_tree, device="cpu"):
    """The reference's train state (numpy leaves: ``params``, ``opt``
    with ``mu``, ``nu`` and the 0-d ``step``, and ``ef`` under int8
    compression) as the port's, the parameters requiring grad."""
    state = params_from_jax(numpy_tree, device)
    for p in pytree.leaves(state["params"]):
        p.requires_grad_(True)
    return state
