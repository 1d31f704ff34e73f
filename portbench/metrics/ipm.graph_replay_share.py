"""``ipm.graph_replay_share``: the IPM step's segments replayed from their
CUDA graphs (counter ``ipm.graph_replays``) over those replayed or run
eagerly (``ipm.eager_segments``) in the window's last request; a program
without the counters gives ``None``."""
from portbench.program_spans import last_result


def read(run):
    res = last_result(run)
    if res is None:
        return None
    replays = res.counts.get("ipm.graph_replays", 0)
    calls = replays + res.counts.get("ipm.eager_segments", 0)
    return replays / calls if calls else None
