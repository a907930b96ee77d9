"""Bytes the decode-only steps must move -- every weight once a step,
the K/V of every decode lane's live context once -- over their time and
the card's HBM rate; the steps outside the profiled stretch."""
from hbm_bench import peaks


def read(run):
    dec = [s for s in run.untraced() if s.kind == "decode"]
    secs = sum(s.step_s for s in dec)
    if not secs:
        return None
    moved = sum(run.decode_bytes(s.index) for s in dec)
    return 100.0 * moved / secs / peaks.HBM_BYTES_PER_S
