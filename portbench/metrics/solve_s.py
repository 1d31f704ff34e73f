"""``solve_s``: the window's wall time over the re-solves completed in it
(a warm re-solve of a built model to its certified answer)."""


def read(run):
    return run.window_s / len(run.records) if run.records else None
