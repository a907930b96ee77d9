"""The measured window's arithmetic: which tokens and gaps fall inside it,
and percentiles over them.

The harness stamps the end of every admission call and of every serving
step on the host clock (one turn of the loop: admission, then step) and
notes, for every request, when it was submitted and in which turn it was
admitted.  The scheduler's rules make the rest exact: a request of
``plen`` prompt tokens admitted in turn ``a`` prefills in chunks in steps
``a .. a + ceil(plen / chunk) - 1``, the last of which gives its first
token, and every later step gives one more token until it has ``olen``.
(The harness checks the rule against every request's result.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence


@dataclasses.dataclass
class RequestLog:
    rid: int
    plen: int
    olen: int
    submit_t: float
    chunk: int                  # prompt tokens a step takes
    admit_step: Optional[int] = None

    def prefill_steps(self) -> int:
        """Steps that prefill the prompt."""
        return -(-self.plen // self.chunk)

    def token_step(self, k: int) -> int:
        """Index of the turn that gives output token ``k``."""
        return self.admit_step + self.prefill_steps() - 1 + k


def percentile(values: Sequence[float], q: float) -> float:
    """``q``-th percentile, linear between order statistics (numpy's
    default): rank ``q / 100 * (n - 1)`` of the sorted values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    r = q / 100.0 * (len(xs) - 1)
    lo = int(math.floor(r))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)


@dataclasses.dataclass
class WindowAccount:
    seconds: float
    steps: int
    output_tokens: int
    itl_s: List[float]
    ttft_s: List[float]
    # turn -> (first position, count) of every prompt chunk it prefilled
    prefill: Dict[int, List[tuple]]
    # turn -> live context of every decode lane (the position fed + 1)
    decode_ctx: Dict[int, List[int]]
    # turn -> output tokens its step gave
    tokens: Dict[int, int]


def account(requests: Sequence[RequestLog], step_end: Dict[int, float],
            first: int, last: int, t0: float) -> WindowAccount:
    """Tokens, gaps and first-token times of the turns ``first..last``
    (inclusive), a window opened at host time ``t0`` and closed at the end
    of step ``last``."""
    inside = lambda s: first <= s <= last    # noqa: E731
    itl, ttft = [], []
    steps = range(first, last + 1)
    pre = {s: [] for s in steps}
    ctx = {s: [] for s in steps}
    toks = {s: 0 for s in steps}
    for r in requests:
        if r.admit_step is None:
            continue
        for j in range(r.prefill_steps()):
            s = r.admit_step + j
            if inside(s):
                pre[s].append((j * r.chunk, min(r.chunk, r.plen - j * r.chunk)))
        prev = None
        for k in range(r.olen):
            s = r.token_step(k)
            if s > last:
                break
            t = step_end[s]
            if inside(s):
                toks[s] += 1
                if k == 0:
                    ttft.append(t - r.submit_t)
                else:
                    ctx[s].append(r.plen + k)     # position plen + k - 1 fed
                    if prev is not None:
                        itl.append(t - prev)
                prev = t
            else:
                prev = None
    return WindowAccount(seconds=step_end[last] - t0, steps=len(steps),
                         output_tokens=sum(toks.values()), itl_s=itl,
                         ttft_s=ttft, prefill=pre, decode_ctx=ctx,
                         tokens=toks)
