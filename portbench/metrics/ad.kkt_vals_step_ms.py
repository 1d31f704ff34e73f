"""``ad.kkt_vals_step_ms``: self time of the Hessian sweep (span
``ad.kkt_vals``, every regularization try) per step of the window's last
request, in milliseconds; a part of ``ad.sweeps_step_ms``."""
from portbench.program_spans import last_result, step_ms


def read(run):
    res = last_result(run)
    return None if res is None else step_ms(res, "ad.kkt_vals")
