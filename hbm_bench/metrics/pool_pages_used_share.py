"""Pages held over the pages of the pool, averaged over the steps
outside the profiled stretch (the scheduler's free-page count after
each step)."""


def read(run):
    steps = run.untraced()
    if not steps or not run.num_pages:
        return None
    return 100.0 * sum(1.0 - s.free_pages / run.num_pages
                       for s in steps) / len(steps)
