"""Process meshes: one rank per process, joined by ``torch.distributed``.

A :class:`RankGroup` is this process's place in a group of ``world``
ranks, each naming its own device.  The group is always initialised
from explicit arguments -- ``addr``, ``port``, ``world``, ``rank`` and
every rank's device -- never from environment defaults, and a group
that fails to initialise raises.

Two planes:

- **Control plane**: host objects (the serving fleet's per-step
  exchange, barriers), always over a ``gloo`` group.
- **Data plane**: tensors (the MoE's model-axis sums, the data ranks'
  gradient sums, checkpoint gathers).  ``nccl`` when every rank has a
  card of its own; ``gloo`` when ranks share a card (NCCL refuses two
  ranks on one GPU) or run on the CPU, staging device tensors through
  host memory.  The backend is a function of the layout alone
  (:func:`data_backend`) and is printed when the group starts.

:func:`launch` starts N ranks as ``python -m <module>`` subprocesses
(each given ``--world/--rank/--addr/--port``), waits for them with a
timeout and raises on any rank's non-zero exit or on the timeout.

Every data-plane collective adds its host seconds (after a device sync)
to its group's ``times``, by kind, so a run can report what its
collectives cost.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist


# how long a collective (or the group's forming) may wait for a rank
GROUP_TIMEOUT = datetime.timedelta(seconds=600)


class RankError(RuntimeError):
    """A rank exited with a non-zero code or outlived its timeout."""


def data_backend(devices: Sequence) -> str:
    """``nccl`` when every rank names a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    cards = [d.index for d in devs if d.type == "cuda"]
    if len(cards) == len(devs) and None not in cards \
            and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def rank_devices(world: int, device="cuda") -> Tuple[torch.device, ...]:
    """The default layout of ``world`` ranks on one host: on the CPU every
    rank on ``cpu``; on cards rank r on card ``r % cards`` (one rank a
    card when there are cards enough, else ranks sharing cards)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (dev,) * world
    n = torch.cuda.device_count()
    return tuple(torch.device("cuda", r % n) for r in range(world))


@dataclasses.dataclass(frozen=True, eq=False)
class RankGroup:
    """This process's rank in a group: ``devices`` names every rank's
    device, ``backend`` the data plane, ``data`` its process group (the
    default group) and ``control`` the gloo group of the control plane.
    ``times`` holds ``[calls, seconds]`` of its data-plane collectives by
    kind."""

    world: int
    rank: int
    devices: Tuple[torch.device, ...]
    backend: str
    data: Any
    control: Any
    times: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(lambda: [0, 0.0]))

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def describe(self) -> str:
        cards = len({str(d) for d in self.devices if d.type == "cuda"})
        return (f"world={self.world}, cards={cards}, data plane="
                f"{self.backend}, control plane=gloo")

    def barrier(self) -> None:
        tdist.barrier(group=self.control)

    def all_gather_object(self, obj) -> List[Any]:
        """Every rank's ``obj`` in rank order, over the control plane."""
        out = [None] * self.world
        tdist.all_gather_object(out, obj, group=self.control)
        return out


def init_ranks(*, addr: str, port: int, world: int, rank: int,
               devices: Sequence) -> RankGroup:
    """Join (and, with the other ranks, form) a group of ``world`` ranks
    at ``tcp://addr:port``; ``devices`` names every rank's device, the
    same list on every rank.  Raises if the group cannot form."""
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != world or world < 1 or not 0 <= rank < world:
        raise ValueError(f"init_ranks(world={world}, rank={rank}) with "
                         f"{len(devices)} devices: need one device per rank")
    if any(d.type == "cuda" and d.index is None for d in devices):
        raise ValueError(f"devices {devices}: name each card with its index "
                         "(cuda:N)")
    if tdist.is_initialized():
        raise RuntimeError("init_ranks(): this process already belongs to a "
                           "process group")
    backend = data_backend(devices)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    tdist.init_process_group(
        backend, init_method=f"tcp://{addr}:{int(port)}", world_size=world,
        rank=rank, timeout=GROUP_TIMEOUT, **kw)
    control = tdist.new_group(backend="gloo")
    group = RankGroup(world=world, rank=rank, devices=devices,
                      backend=backend, data=tdist.group.WORLD,
                      control=control)
    print(f"[ranks] rank {rank} on {dev}: {group.describe}", flush=True)
    return group


def shutdown() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()


# ---- data plane -------------------------------------------------------------


@contextlib.contextmanager
def _timed(group: RankGroup, kind: str, device: torch.device):
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    row = group.times[kind]
    row[0] += 1
    row[1] += time.perf_counter() - t0


def all_gather(group: RankGroup, t: torch.Tensor, pg=None,
               kind: str = "all_gather") -> List[torch.Tensor]:
    """Every rank of ``pg`` (default: the whole group)'s ``t``, in rank
    order, on ``t``'s device.  Over gloo a device tensor travels through
    host memory, as raw bytes."""
    pg = group.data if pg is None else pg
    n = tdist.get_world_size(pg)
    src = t.detach().contiguous()
    with _timed(group, kind, src.device):
        if group.backend == "gloo":
            raw = src.to("cpu").reshape(-1).view(torch.uint8)
            out = [torch.empty_like(raw) for _ in range(n)]
            tdist.all_gather(out, raw, group=pg)
            return [o.view(src.dtype).reshape(src.shape).to(src.device)
                    for o in out]
        out = [torch.empty_like(src) for _ in range(n)]
        tdist.all_gather(out, src, group=pg)
        return out


def ordered_sum(group: RankGroup, t: torch.Tensor, pg=None,
                kind: str = "ordered_sum") -> torch.Tensor:
    """The sum of every rank of ``pg``'s ``t``, added in rank order (the
    same bits on every rank and in every run)."""
    parts = all_gather(group, t, pg, kind)
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y


# ---- launching ranks --------------------------------------------------------


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def add_rank_args(ap) -> None:
    """The explicit group arguments every rank program takes."""
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--addr", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)


def _pythonpath(env: Dict[str, str]) -> str:
    src = str(Path(__file__).resolve().parents[2])
    old = env.get("PYTHONPATH", "")
    return src if not old else f"{src}{os.pathsep}{old}"


def launch(module: str, world: int, args: Sequence[str] = (), *,
           timeout_s: float, env: Optional[Dict[str, str]] = None
           ) -> List[str]:
    """Run ``python -m module *args --world N --rank r --addr 127.0.0.1
    --port P`` (P a free port) for every rank r, wait for all of them and
    return their outputs (stdout and stderr together) in rank order.
    Raises :class:`RankError` (with the tail of every rank's output) when
    a rank exits non-zero or the ranks outlive ``timeout_s``; every rank
    still running then is killed."""
    addr, port = "127.0.0.1", free_port()
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = _pythonpath(env)
    logs, procs = [], []
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        try:
            for r in range(world):
                f = open(os.path.join(tmp, f"rank{r}.log"), "w+")
                logs.append(f)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *map(str, args),
                     "--world", str(world), "--rank", str(r), "--addr", addr,
                     "--port", str(port)],
                    stdout=f, stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout_s
            failed = None
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with {procs[bad[0]].poll()}"
                    time.sleep(2.0)       # let the others report
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout_s:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
        codes = [p.returncode for p in procs]
        if failed is None and any(codes):
            failed = f"exit codes {codes}"
        if failed is not None:
            tails = "\n".join(f"--- rank {r} (exit {c}) ---\n{o[-3000:]}"
                              for r, (c, o) in enumerate(zip(codes, outs)))
            raise RankError(f"{module} over {world} ranks: {failed}\n{tails}")
        return outs
