"""``solver_setup_s``: ``optimize``'s wall time less the solver's own
``solve_time`` (the solver's construction: the KKT's structure analysis,
the segment-sum plans), averaged over the window's untraced requests."""
from portbench.harness import mean


def read(run):
    return mean([r["optimize_s"] - r["solve_time"] for r in run.untraced])
