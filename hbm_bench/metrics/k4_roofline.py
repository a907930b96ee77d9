"""The paged decode attention kernel's least time -- its decode lanes'
live K/V read once, every word through the SECDED round, the attention
products -- over its device time, in the decode-only steps of the
profiled stretch (one launch a layer and step, attributed to the step
whose span it starts in; a step in which the trace shows another count
is left out of both sums)."""
from hbm_bench import peaks

KERNEL = "paged_decode_kernel"


def read(run):
    st = run.stretch
    if st is None:
        return None
    steps = sorted((s for s in run.steps if s.index in set(st["steps"])),
                   key=lambda s: s.index)
    if len(steps) != len(st["step_spans"]):
        return None
    layers = run.cfg["num_hidden_layers"]
    least = spent = 0.0
    for rec, (a, b, kind) in zip(steps, st["step_spans"]):
        ctx = run.decode_ctx(rec.index)
        if kind != rec.kind or kind != "decode" or not ctx:
            continue
        launches = [t for n, t0, t in st["ops"]
                    if KERNEL in n and a <= t0 <= b]
        if len(launches) != layers:
            continue
        least += layers * peaks.k4_launch_bound_s(run.cfg, ctx)
        spent += sum(launches)
    return 100.0 * least / spent if spent else None
