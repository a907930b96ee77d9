"""Structured event trace: a bounded ring of typed scheduler events
(port of :mod:`repro.obs.trace`).

Every control-plane decision the serving loop makes on the host --
admission, retirement, CapacityError backpressure, COW forks, page
migrations, quarantines, block retirements, governor replans, setpoint
escalations -- lands here as one typed event with a step-index
timestamp.  The ring is bounded (old events drop), but per-kind counts
are cumulative, so exporters can report lifetime totals even after the
ring wraps.  Export is JSONL (one event per line) for offline
debugging of a serving incident: "which tenant's admission forced the
replan that moved shard 3 to 0.94 V?" is a grep, not a re-run.

Events are host-side by construction -- the serving step emits nothing
-- so the trace adds no work on the device and cannot change the launch
budget.
"""
from __future__ import annotations

import collections
import dataclasses
import io
import json
from typing import Any, Dict, Iterator, Optional

# The closed set of event kinds the scheduler emits.  Exporters and
# dashboards key on these; adding a kind is backward-compatible,
# renaming is not.
EVENT_KINDS = (
    "admission", "retirement", "backpressure", "cow_fork", "migration",
    "quarantine", "block_retire", "prefix_evict", "replan", "escalation",
)


@dataclasses.dataclass(frozen=True)
class Event:
    """One typed scheduler event.

    ``step`` is the scheduler's step index at emission time (the only
    clock the serving loop has that survives replay); ``shard``/``rid``
    are optional labels; ``data`` carries kind-specific fields.
    """

    kind: str
    step: int
    shard: Optional[int] = None
    rid: Any = None
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"kind": self.kind, "step": self.step}
        if self.shard is not None:
            out["shard"] = self.shard
        if self.rid is not None:
            out["rid"] = str(self.rid)
        if self.data:
            out.update(self.data)
        return out


class EventTrace:
    """Bounded ring of :class:`Event` with cumulative per-kind counts."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"trace capacity {capacity} must be >= 1")
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.counts: collections.Counter = collections.Counter()
        self.emitted = 0

    def emit(self, kind: str, *, step: int, shard: Optional[int] = None,
             rid: Any = None, **data: Any) -> Event:
        if kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown event kind {kind!r}; known kinds: "
                f"{EVENT_KINDS}")
        ev = Event(kind=kind, step=int(step), shard=shard, rid=rid,
                   data=data)
        self._ring.append(ev)
        self.counts[kind] += 1
        self.emitted += 1
        return ev

    def __len__(self) -> int:
        return len(self._ring)

    def __iter__(self) -> Iterator[Event]:
        return iter(self._ring)

    def events(self, kind: Optional[str] = None):
        """Events still in the ring, oldest first (optionally one kind)."""
        return [e for e in self._ring if kind is None or e.kind == kind]

    # ---- export ----------------------------------------------------------
    def to_jsonl(self, path_or_file) -> int:
        """Write the ring as JSON Lines; returns the event count."""
        own = isinstance(path_or_file, (str, bytes))
        f = open(path_or_file, "w") if own else path_or_file
        try:
            for ev in self._ring:
                f.write(json.dumps(ev.to_dict(), default=str) + "\n")
        finally:
            if own:
                f.close()
        return len(self._ring)

    def jsonl(self) -> str:
        buf = io.StringIO()
        self.to_jsonl(buf)
        return buf.getvalue()
