"""``build_solve_s``: the window's wall time over the requests completed
in it (a new model built, transcribed, given a solver and solved)."""


def read(run):
    return run.window_s / len(run.records) if run.records else None
