"""``ipm.step_ms``: the solver's ``timers["step_total"]`` summed over the
window's solves, over their iterations, in milliseconds."""
import math


def read(run):
    iters = sum(r["iter"] for r in run.untraced)
    total = sum(r["step_total"] for r in run.untraced)
    if not iters or not math.isfinite(total):
        return None
    return 1e3 * total / iters
