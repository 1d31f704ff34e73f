"""``ipm.cold_solve_s``: the solver's own ``solve_time`` of a freshly
built model (the IPM loop from the start point, every CUDA graph of the
new model captured on its first call), averaged over the window's
untraced requests."""
from portbench.harness import mean


def read(run):
    return mean([r["solve_time"] for r in run.untraced])
