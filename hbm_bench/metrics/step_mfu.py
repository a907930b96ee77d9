"""Model FLOPs of the serving steps (mixed and decode-only alike) over
the scheduler's own timing of them and the card's bf16 peak: the whole
step's share of the chip, beside the kernels' rooflines; the steps
outside the profiled stretch."""
from hbm_bench import peaks


def read(run):
    steps = run.untraced()
    secs = sum(s.step_s for s in steps)
    if not secs:
        return None
    flops = sum(run.step_flops(s.index) for s in steps)
    return 100.0 * flops / secs / peaks.BF16_FLOPS_PER_S
