"""``ipm.iters_per_solve``: the solver's ``res.iter``, averaged over the
window's solves."""
from portbench.harness import mean


def read(run):
    return mean([r["iter"] for r in run.records])
