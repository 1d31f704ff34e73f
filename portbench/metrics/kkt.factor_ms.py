"""``kkt.factor_ms``: one factorization of the structured KKT (BCR or the
scenario Schur complement, K1 among it) in milliseconds,
``IpmSolver.profile_phases()`` at the start point after the window; on
the card only."""
from portbench.metrics_common import phase_ms


def read(run):
    return phase_ms(run, "factor")
