"""``ad.graph_replay_share``: the AD sweeps replayed from their CUDA graphs
(counter ``ad.graph_replays``) over those replayed or run eagerly
(``ad.eager_sweeps``) in the window's last request; a program without
the counters gives ``None``."""
from portbench.program_spans import last_result


def read(run):
    res = last_result(run)
    if res is None:
        return None
    replays = res.counts.get("ad.graph_replays", 0)
    calls = replays + res.counts.get("ad.eager_sweeps", 0)
    return replays / calls if calls else None
