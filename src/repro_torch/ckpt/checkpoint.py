"""Atomic checkpoint/restore with async writing (port of
:mod:`repro.ckpt.checkpoint`), in the reference's file format.

One ``step_<N>.npz`` per checkpoint (leaves keyed by the tree's keystr,
e.g. ``['params']['embed']``) plus ``step_<N>.json`` metadata, each
written to a temporary name and renamed, so a torn write never shadows a
good checkpoint.  numpy has no bfloat16: such leaves are stored as their
raw 16-bit words under ``<key>@bfloat16``, as the reference stores them,
so a checkpoint either package wrote restores into the other's state bit
for bit.  Restore maps leaves into a caller-provided template, casting
to its dtypes and moving to its devices.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import pytree

# torch dtypes numpy lacks, stored as same-width raw words under
# "<key>@<name>" (names as ml_dtypes spells them).
_RAW = {torch.bfloat16: "bfloat16"}
_RAW_VIEW = {"bfloat16": (np.uint16, torch.int16, torch.bfloat16)}


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host as numpy (raw words for bf16)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype in _RAW:
        words, _, _ = _RAW_VIEW[_RAW[t.dtype]]
        return t.view(torch.int16).numpy().view(words)
    return t.numpy()


def _flatten(state) -> Dict[str, np.ndarray]:
    out = {}
    for path, leaf in pytree.flatten_with_path(state):
        key = pytree.keystr(path)
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype in _RAW:
                key = f"{key}@{_RAW[leaf.dtype]}"
            out[key] = _host(leaf)
        else:
            out[key] = np.asarray(leaf)
    return out


def _decode(k: str, v: np.ndarray) -> Tuple[str, torch.Tensor]:
    if "@" in k:
        k, name = k.rsplit("@", 1)
        _, signed, dtype = _RAW_VIEW[name]
        return k, torch.from_numpy(v.copy()).view(signed).view(dtype)
    return k, torch.from_numpy(np.array(v, copy=True))


def _write(directory: str, step: int, leaves: Dict[str, np.ndarray],
           metadata: Optional[Dict[str, Any]]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}.npz")
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **leaves)
    os.replace(tmp, final)                      # atomic
    meta = {"step": step, **(metadata or {})}
    mtmp = final.replace(".npz", ".json") + ".tmp"
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, final.replace(".npz", ".json"))
    return final


def save(directory: str, step: int, state: Any,
         metadata: Optional[Dict[str, Any]] = None) -> str:
    return _write(directory, step, _flatten(state), metadata)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[len("step_"):-len(".npz")])
             for f in os.listdir(directory)
             if f.startswith("step_") and f.endswith(".npz")]
    return max(steps) if steps else None


def restore(directory: str, template: Any,
            step: Optional[int] = None) -> Tuple[Any, Dict[str, Any]]:
    """Restore into ``template``'s structure, dtypes and devices; returns
    (state, metadata).  Parameters that require grad in the template
    require grad in the result."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}.npz")
    with np.load(path) as data:
        stored = dict(_decode(k, data[k]) for k in data.files)
    state = pytree.tree_map(lambda t: t, template)
    for p, leaf in pytree.flatten_with_path(template):
        t = stored[pytree.keystr(p)].to(device=leaf.device, dtype=leaf.dtype)
        if leaf.requires_grad:
            t.requires_grad_(True)
        pytree.set_path(state, p, t)
    with open(path.replace(".npz", ".json")) as f:
        meta = json.load(f)
    return state, meta


class AsyncCheckpointer:
    """Background-thread writer: training never blocks on file I/O.

    :meth:`submit` copies the state to the host before queueing it, so
    the next (in-place) step may overwrite the device tensors."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, step: int, state: Any,
               metadata: Optional[Dict[str, Any]] = None) -> None:
        self._q.put((step, _flatten(state), metadata))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, leaves, metadata = item
            try:
                _write(self.directory, step, leaves, metadata)
                self._gc()
            except Exception as e:          # noqa: BLE001  (re-raised)
                self._errors.append(e)

    def _gc(self) -> None:
        steps = sorted(
            int(f[len("step_"):-len(".npz")])
            for f in os.listdir(self.directory)
            if f.startswith("step_") and f.endswith(".npz"))
        for s in steps[: -self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.directory,
                                           f"step_{s:08d}{ext}"))
                except OSError:
                    pass

    def finalize(self) -> None:
        """Write everything queued, stop the worker, raise its first
        error."""
        self._q.put(None)
        self._worker.join(timeout=120)
        if self._worker.is_alive():
            raise TimeoutError("checkpoint writer did not finish in 120 s")
        if self._errors:
            raise self._errors[0]
