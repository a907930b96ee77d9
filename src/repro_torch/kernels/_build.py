"""Build and load the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/*.cu`` source becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` at first use into ``build/kernels/``
at the repository root (listed in ``.gitignore``) and loaded with
``ctypes``.  Library names carry a hash of the sources and flags, so an
edited kernel is never served from a stale build.  :func:`build_all`
starts one ``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.

Every kernel wrapper counts its launches in :data:`LAUNCHES` (one per
kernel launch, nowhere else), so a run can show that a path really went
through the kernels.  A kernel with variants also counts each launch under
``"<kernel>/<variant>"`` (:func:`variant_counts`).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# kernel library -> (source file, C entry point, ctypes argtypes)
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_LL = ctypes.c_longlong
KERNELS = {
    "arena_bitflip": ("arena_bitflip.cu", "launch_arena_bitflip",
                      [_P, _P, _P, _P, _I, _U, _I, _I, _P]),
    "arena_ecc": ("arena_ecc.cu", "launch_arena_ecc",
                  [_P, _P, _P, _P, _P, _P, _I, _U, _I, _P]),
    "faulty_decode": ("faulty_decode.cu", "launch_faulty_decode",
                      [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _I,
                       _U, _U, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _F, _U, _I, _I, _I, _I, _I, _P]),
    "paged_decode": ("paged_decode.cu", "launch_paged_decode",
                     [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _U,
                      _I, _I, _I, _I, _I, _P]),
    "segment_bitflip": ("segment_bitflip.cu", "launch_segment_bitflip",
                        [_P, _P, _LL, _U, _P, _U, _I, _I, _P]),
    "segment_ecc": ("segment_ecc.cu", "launch_segment_ecc",
                    [_P, _P, _P, _LL, _U, _P, _U, _I, _P]),
    "flash_prefill": ("flash_prefill.cu", "launch_flash_prefill",
                      [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _F, _I, _I, _P]),
    "rglru_scan": ("rglru_scan.cu", "launch_rglru_scan",
                   [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    _P]),
}

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return {name: int(LAUNCHES[name]) for name in KERNELS}


def variant_counts(name: str) -> Dict[str, int]:
    """Launches of kernel ``name`` by variant."""
    prefix = name + "/"
    return {key[len(prefix):]: int(n) for key, n in LAUNCHES.items()
            if key.startswith(prefix)}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src, _, _ = KERNELS[name]
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.suffix == ".cuh" or f.name == src):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def _nvcc_cmd(name: str, out: Path) -> list:
    src, _, _ = KERNELS[name]
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / src)]


def build_all(names: Iterable[str] = None, verbose: bool = False) -> Dict[str, Path]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` process per source, all started together."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _nvcc_cmd(name, tmp)
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        tmp.replace(out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def kernel(name: str):
    """The C entry point of one kernel library, built and loaded on first
    use, with its ctypes signature set."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            path = build_all([name])[name]
            _, entry, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(str(path)), entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn


def check(name: str, err: int, variant: str = None) -> None:
    """Raise if a launch returned a CUDA error code; count it otherwise
    (and under its variant, if it has one)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name}"
                           f"{'' if variant is None else ' ' + variant} "
                           f"launch failed with cudaError_t {err}")
    LAUNCHES[name] += 1
    if variant is not None:
        LAUNCHES[f"{name}/{variant}"] += 1
