"""One decode step, captured once as a CUDA graph and replayed.

The reference runs every decode step through one jitted, donated
function: traced once (``decode_traces == 1``), replayed with its state
updated in place.  :class:`CapturedStep` is the port's counterpart.  It
owns a step body -- a function of no arguments that reads the step's
static device buffers and writes its state in place -- and the step's
static input buffers.

On the card:

  * the first call runs the body eagerly, for real, on the device's side
    stream: it is one of the steps the request takes (ring writes and
    recurrent state are not idempotent), and it builds the kernels and
    the workspaces the capture will bake in (K3 / K4's per-stream scratch,
    cuBLAS's per-stream workspace);
  * the second call captures the body on that stream
    (``CUDAGraph.capture_begin`` / ``capture_end``: capture records the
    launches and runs none of them), then replays the graph; every later
    call replays it.  Unlike ``torch.cuda.graph`` it does not empty the
    allocator's cache first, which a capture per request would pay for
    in fresh device allocations.  The capture runs with Python's cyclic
    garbage collector paused: a dead graph (a dropped scheduler's, held in
    a reference cycle) torn down by the collector during a capture
    invalidates that capture in either error mode
    (``scripts/capture_gc_probe.py``).  It checks only this thread's CUDA
    calls (``thread_local``); the body's own calls are held to the strict
    rules;
  * the launches a wrapper counts in :data:`repro_torch.kernels._build.
    LAUNCHES` while the body is captured are taken back out of the count
    and added again at every replay, so the count still says how many
    kernels each step launched;
  * a capture that fails raises: there is no fallback to the eager step;
  * ``pool`` (a ``torch.cuda.graph_pool_handle()``) lets graphs that never
    run at once share one private memory pool (the bucketed prefill's
    graphs of :mod:`repro_torch.serving.engine`).

On the CPU (and on the card with ``capture=False``) every call runs the
same body eagerly, so the CPU tests exercise exactly the code that is
captured on the card.
"""
from __future__ import annotations

import collections
import gc
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import faulty


# One side stream per device for every step's warm-up and capture, as
# torch.cuda.graph keeps one default capture stream: the per-stream
# workspaces a warm-up creates (cuBLAS's, K3 / K4's) are made once, not
# once for every request.
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    if index not in _SIDE_STREAMS:
        _SIDE_STREAMS[index] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[index]


class CapturedStep:
    """A decode step body, captured once and replayed on a CUDA device.

    ``inputs`` maps names to the step's static device buffers, which the
    body reads; :meth:`load` copies new values into them through pinned
    host memory before a step.  Calling the object runs one step and
    returns what the body returns (on the card after the first call, the
    graph's static outputs, valid until the next call).  ``traces``
    counts the bodies captured on the card, or built on the eager path:
    1 once the step has run (the reference's ``decode_traces``)."""

    def __init__(self, body: Callable[[], object], device, *,
                 inputs: Optional[Dict[str, torch.Tensor]] = None,
                 capture: bool = True, pool=None):
        self.body = body
        self.pool = pool
        self.device = torch.device(device)
        self.capture = bool(capture) and self.device.type == "cuda"
        self.inputs = dict(inputs or {})
        pin = self.device.type == "cuda"
        self._host = {name: torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=pin)
                      for name, t in self.inputs.items()}
        self._copied: Optional[torch.cuda.Event] = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.traces = 0
        self._launches: collections.Counter = collections.Counter()
        self._keep = ()

    def load(self, **values) -> None:
        """Copy host values (arrays or CPU tensors of each buffer's shape)
        into the named static input buffers, through pinned memory and
        without a host sync (the copy of the previous step is waited for
        before its pinned buffer is written again)."""
        if self._copied is not None:
            self._copied.synchronize()
        for name, value in values.items():
            host = self._host[name]
            host.copy_(torch.as_tensor(value).reshape(host.shape))
            self.inputs[name].copy_(host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(self.device))

    def __call__(self):
        if not self.capture:
            self.traces = 1
            return self.body()
        if self._stream is None:
            return self._warm_up()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        _build.LAUNCHES.update(self._launches)
        return self.outputs

    def _warm_up(self):
        """The first step, eager on the side stream the capture will use."""
        cur = torch.cuda.current_stream(self.device)
        self._stream = _side_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self.body()
        cur.wait_stream(self._stream)
        torch.cuda.synchronize(self.device)
        return out

    def _capture(self) -> None:
        before = collections.Counter(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    self.outputs = self.body()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self._launches = collections.Counter(_build.LAUNCHES) - before
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(before)
        # the graph holds the capture stream's K3 / K4 scratch addresses
        self._keep = faulty.stream_workspace(self.device,
                                             self._stream.cuda_stream)
        self.graph = graph
        self.traces += 1
