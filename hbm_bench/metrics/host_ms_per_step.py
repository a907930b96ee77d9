"""Host time a step of the serving loop spends outside the scheduler's
timed step and the admission call: the loop's wall time minus both,
over the steps outside the profiled stretch."""


def read(run):
    steps = run.untraced()
    if not steps:
        return None
    return 1e3 * sum(s.loop_s - s.step_s - s.admit_s for s in steps) / len(
        steps)
