"""``kkt.regularizations_per_solve``: the regularization ladder's tries
after the first (counter ``kkt.regularizations``; each assembles and
factors again) in the window's last request."""
from portbench.program_spans import last_result


def read(run):
    res = last_result(run)
    return None if res is None else res.counts.get("kkt.regularizations", 0)
