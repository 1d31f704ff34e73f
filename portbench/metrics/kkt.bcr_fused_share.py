"""``kkt.bcr_fused_share``: the band factorization's BCR levels whose Schur
update ran as K2, the hand-written kernel beside K1 (counter
``kkt.bcr_fused_levels``), over those that ran it either way (plus
``kkt.bcr_eager_levels``, the torch Gram form) in the window's last
request; ``None`` from a program without the counters or a request with no
BCR level."""
from portbench.program_spans import last_result


def read(run):
    res = last_result(run)
    if res is None:
        return None
    fused = res.counts.get("kkt.bcr_fused_levels", 0)
    levels = fused + res.counts.get("kkt.bcr_eager_levels", 0)
    return fused / levels if levels else None
