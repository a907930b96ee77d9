"""Model FLOPs of every position the window's steps processed (prompt
chunks and decoded tokens, attention over the live context) and of the
output head for every token they gave, over the loop's wall time and the
card's bf16 peak; the steps outside the profiled stretch."""
from hbm_bench import peaks


def read(run):
    steps = run.untraced()
    wall = sum(s.loop_s for s in steps)
    if not wall:
        return None
    flops = sum(run.step_flops(s.index) for s in steps)
    return 100.0 * flops / wall / peaks.BF16_FLOPS_PER_S
