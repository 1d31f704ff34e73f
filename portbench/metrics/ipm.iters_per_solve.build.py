"""``ipm.iters_per_solve.build``: the solver's ``res.iter``, averaged over
the window's cold solves (``ipm.iters_per_solve`` of the build cells,
which report ``build_solve_s`` in place of ``solve_s``)."""
from portbench.harness import mean


def read(run):
    return mean([r["iter"] for r in run.records])
