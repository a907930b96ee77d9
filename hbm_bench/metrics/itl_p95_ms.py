"""95th percentile of every gap between consecutive output tokens of a
request, both inside the window, over all requests."""
from hbm_bench.window import percentile


def read(run):
    gaps = run.account.itl_s
    return 1e3 * percentile(gaps, 95) if gaps else None
