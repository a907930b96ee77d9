"""Share of the profiled stretch in which no operation ran on the card
(the union of the traced device intervals).  It includes the profiler's
own cost per launch."""


def read(run):
    st = run.stretch
    if st is None or not st["window_s"] or not st["ops"]:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])
