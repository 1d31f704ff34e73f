"""Arithmetic that several metric readers share."""


def phase_ms(run, phase):
    """One phase of ``IpmSolver.profile_phases()`` at the start point, in
    milliseconds, measured once per run after the window; on the card
    only."""
    solver = run.system.solver()
    if not run.on_card or solver is None:
        return None
    phases = run.memo("profile_phases", solver.profile_phases)
    return 1e3 * phases[phase] if phase in phases else None


def idle_pct(run):
    """The card's idle share of the first traced request, in percent; on
    the card only."""
    if not run.on_card or run.trace is None:
        return None
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
