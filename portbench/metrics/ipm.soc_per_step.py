"""``ipm.soc_per_step``: second-order corrections tried (counter
``ipm.soc_trials``: a first trial point rejected without a fall in the
constraint violation, then one more solve and trial) per step of the
window's last request; a program without the counter gives ``None``."""
from portbench.program_spans import last_result


def read(run):
    res = last_result(run)
    trials = None if res is None else res.counts.get("ipm.soc_trials")
    return None if trials is None else trials / res.iter
