"""``kkt.solve_graph_replay_share``: the KKT solves replayed from their
CUDA graphs (counter ``kkt.solve_graph_replays``) over those replayed or
run eagerly (``kkt.eager_solves``) in the window's last request; a program
without the counters gives ``None``."""
from portbench.program_spans import last_result


def read(run):
    res = last_result(run)
    if res is None:
        return None
    replays = res.counts.get("kkt.solve_graph_replays", 0)
    calls = replays + res.counts.get("kkt.eager_solves", 0)
    return replays / calls if calls else None
