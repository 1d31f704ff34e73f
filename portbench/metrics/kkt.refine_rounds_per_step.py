"""``kkt.refine_rounds_per_step``: rounds of the condensed solve's
iterative refinement (counter ``kkt.refine_rounds``: each a solve and a
matvec, every regularization try included) per step of the window's last
request; a program without the counter gives ``None``."""
from portbench.program_spans import last_result


def read(run):
    res = last_result(run)
    rounds = None if res is None else res.counts.get("kkt.refine_rounds")
    return None if rounds is None else rounds / res.iter
