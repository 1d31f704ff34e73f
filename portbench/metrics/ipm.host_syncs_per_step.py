"""``ipm.host_syncs_per_step``: calls of ``ipm.host_sync`` under
``ipm.step`` per step of the window's last request."""
from portbench.program_spans import calls_per_step, last_result


def read(run):
    res = last_result(run)
    return None if res is None else calls_per_step(res, "ipm.host_sync")
