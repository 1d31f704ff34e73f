"""``ad.kkt_vals_ms``: the Hessian AD sweep (``SimdModel.kkt_vals``) in
milliseconds, ``IpmSolver.profile_phases()`` at the start point after the
window (synchronised wall time); on the card only."""
from portbench.metrics_common import phase_ms


def read(run):
    return phase_ms(run, "kkt_vals")
