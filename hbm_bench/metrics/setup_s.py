"""Process start to the first timed step: weights drawn on the device,
the scheduler, its pool and tables, the warm-up request (one mixed step
at the cell's chunk and the decode capture), and, on a checkout's first
run, the kernels' build."""


def read(run):
    return run.setup_s
