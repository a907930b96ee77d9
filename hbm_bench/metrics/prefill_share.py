"""Share of the loop's wall time spent in the scheduler's eager mixed
steps (the chunked prefill), outside the profiled stretch."""


def read(run):
    steps = run.untraced()
    wall = sum(s.loop_s for s in steps)
    if not wall:
        return None
    spent = sum(s.step_s for s in steps if s.kind == "mixed")
    return 100.0 * spent / wall
