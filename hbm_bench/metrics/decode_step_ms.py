"""Mean host-clock time of the scheduler's decode-only steps (the
captured step, ending in the token read), outside the profiled stretch."""


def read(run):
    dec = [s.step_s for s in run.untraced() if s.kind == "decode"]
    return 1e3 * sum(dec) / len(dec) if dec else None
