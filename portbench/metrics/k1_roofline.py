"""``k1_roofline``: K1's least time over its device time in the window, in
percent.  The least time of each launch recorded in the window is the
larger of its bytes (each input block read once, ``L`` and ``L^{-1}``
written once: ``3 nb n^2`` elements) over the card's bandwidth and its
operations (``n^3 / 3`` for the Cholesky and ``n^3 / 3`` for the
triangular inverse, per block) over the card's peak for the dtype; the
device time is that of every kernel whose name contains ``chol_linv``."""

DTYPES = {8: "float64", 4: "float32"}


def bound_s(nb, n, esize, peak):
    t_bytes = 3 * nb * n * n * esize / peak["hbm_bytes_per_s"]
    t_ops = nb * (2.0 * n ** 3 / 3.0) / peak["flops_per_s"][DTYPES[esize]]
    return max(t_bytes, t_ops)


def read(run):
    if not run.on_card or run.trace is None or not run.k1_launches:
        return None
    peak = run.peaks.get(run.device_name)
    k1_s = sum(s for k, s in run.trace["kernels_s"].items()
               if "chol_linv" in k)
    if peak is None or k1_s <= 0:
        return None
    least = sum(bound_s(nb, n, es, peak) for nb, n, es in run.k1_launches)
    return 100.0 * least / k1_s
