"""``graphs.captures_per_solve``: the CUDA graphs captured in the window's
last request (counters ``ad.graph_captures``, ``kkt.solve_graph_captures``
and ``ipm.graph_captures``): each captured anew for a new model, none on
the CPU; a program without the counters gives ``None``."""
from portbench.program_spans import last_result

COUNTERS = ("ad.graph_captures", "kkt.solve_graph_captures",
            "ipm.graph_captures")


def read(run):
    res = last_result(run)
    if res is None or not any(c in res.counts for c in COUNTERS):
        return None
    return sum(res.counts.get(c, 0) for c in COUNTERS)
