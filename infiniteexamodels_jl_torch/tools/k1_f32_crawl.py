"""opf-1000 in the "mixed" step set on the card, with K1 and with its plain
version in K1's place.

    python -m infiniteexamodels_jl_torch.tools.k1_f32_crawl [--size 1000]
        [--compare 12] [--factor-dtype mixed|float64] [--max-iter 3000]

Solves ``opf(num_supports=size)`` through ``ExaTranscriptionBackend(
IpmSolver, linear_solver="auto", tol=1e-6, factor_dtype="mixed")`` twice:
once with ``chol_linv_reference`` in place of K1 (a hook around
``block_tridiag._chol_linv``, as chip_smoke's recording hook; nothing in
the package changes), once with K1.  In the K1 run the first ``--compare``
f32 factorizations are also run through the plain version, and both are
held against each other: blocks that failed (not SPD in f32) in each, the
worst backward errors ||LL^T - D||/||D|| and ||L^{-1}L - I|| of the blocks
both factored, K1's least pivots (``pivot_ratios``), the least eigenvalue
of the blocks (in f64).  With ``--factor-dtype float64`` the solves run
the f64 step set and the f64 factorizations are compared the same way.
Prints one JSON line per run: status, iterations, objective, the host
returns, and per step (f32 step set?, iteration, status, mu, the
refinement residual, delta_w, line-search trials).

``--size 2000 --factor-dtype float64 --compare 100`` is the reproduction
of ROADMAP 3.7, K1's f64 pivot test on opf-2000 (NVIDIA H100 80GB HBM3,
700 W).  With the test at ``sqrt(n) u D_jj`` the K1 run crawled from
iteration 18 on (alpha ~2e-4 a step; ``acceptable`` when cut at 60), the
scenario blocks indefinite at round-off level, and over 60 compared
factorizations the plain version rejected one block that K1 factored
(K1's least pivot 21.2 eps D_jj).  With the test at ``2 n u D_jj`` the
K1 run ends ``first_order`` in 16 iterations at 5744.48231909455 (the
plain version in K1's place: 45, at 5744.482319094537); over all 20 f64
factorizations K1 rejects 2,776 blocks that the plain version factors,
and the plain version none that K1 factors (``failed_plain_only`` 0).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..backend import ExaTranscriptionBackend
from ..models import opf
from ..solvers import IpmSolver, block_tridiag
from ..solvers.chol_linv import (chol_linv, chol_linv_reference,
                                 pivot_threshold, scaled_pivots)


def _backward(D, L, Linv):
    D, L, X = D.double(), L.double(), Linv.double()
    eye = torch.eye(D.shape[-1], dtype=torch.float64, device=D.device)
    fact = (torch.linalg.matrix_norm(L @ L.transpose(-1, -2) - D)
            / torch.linalg.matrix_norm(D))
    return fact, torch.linalg.matrix_norm(X @ L - eye)


def pivot_ratios(D, L):
    """Per block, the least pivot relative to its diagonal entry,
    min_j L_jj^2 / D_jj, in units of the dtype's epsilon (NaN where L is
    NaN)."""
    n, eps = D.shape[-1], torch.finfo(D.dtype).eps
    return scaled_pivots(D, L) * pivot_threshold(n, D.dtype) / eps


def _quantiles(t):
    if t.numel() == 0:
        return None
    q = torch.tensor([0.0, 0.01, 0.1, 0.5], dtype=t.dtype, device=t.device)
    return [float(v) for v in torch.quantile(t, q)]


def _compare(D):
    """K1 against the plain version on one factorization's blocks: the
    blocks each rejected, the backward errors where both factor, and K1's
    least pivot ratios (``pivot_ratios``: quantiles over the blocks only
    K1 factors and over those both factor, and how many of the latter sit
    under 1, 2, 4 and 8 epsilons)."""
    Lk, Xk, _ = chol_linv(D)
    Lp, Xp, _ = chol_linv_reference(D)
    fin_k = torch.isfinite(Xk).all(dim=(1, 2))
    fin_p = torch.isfinite(Xp).all(dim=(1, 2))
    both = fin_k & fin_p
    fk, ik = _backward(D, Lk, Xk)
    fp, ip = _backward(D, Lp, Xp)
    ratio = pivot_ratios(D, Lk)

    def worst(t):
        return float(t[both].max()) if bool(both.any()) else None
    return {"blocks": D.shape[0],
            "failed_k1": int((~fin_k).sum()),
            "failed_plain": int((~fin_p).sum()),
            "failed_k1_only": int((~fin_k & fin_p).sum()),
            "failed_plain_only": int((fin_k & ~fin_p).sum()),
            "fact_k1": worst(fk), "fact_plain": worst(fp),
            "inv_k1": worst(ik), "inv_plain": worst(ip),
            "k1_pivot_eps_plain_failed": _quantiles(ratio[fin_k & ~fin_p]),
            "k1_pivot_eps_both": _quantiles(ratio[both]),
            "both_under_eps": {c: int((ratio[both] <= c).sum())
                               for c in (1, 2, 4, 8)},
            "min_eig": float(torch.linalg.eigvalsh(D.double())[:, 0].min())}


class _Logged(IpmSolver):
    def solve(self, *a, **k):
        self.log = []
        return super().solve(*a, **k)

    def _step(self, st, consts, kkt=None):
        st = super()._step(st, consts, kkt)
        self.log.append([int(kkt is not None and kkt is self.kkt32),
                         int(st.iter), int(st.status), float(st.mu),
                         float(st.log_rr), float(st.log_delta_w),
                         int(st.log_ls)])
        return st


def run(size, plain, compare, factor_dtype="mixed", max_iter=3000):
    k1 = block_tridiag._chol_linv
    dtype = torch.float64 if factor_dtype == "float64" else torch.float32
    calls, cmp = [0], []

    def hook(D):
        if D.dtype == dtype:
            calls[0] += 1
            if not plain and calls[0] <= compare:
                cmp.append(_compare(D.contiguous()))
        return chol_linv_reference(D.contiguous()) if plain else k1(D)

    block_tridiag._chol_linv = hook
    try:
        m = opf(num_supports=size)
        backend = ExaTranscriptionBackend(_Logged, linear_solver="auto",
                                          tol=1e-6, factor_dtype=factor_dtype,
                                          max_iter=max_iter, print_level=0)
        m.set_transformation_backend(backend)
        backend.build(m)
        chol_linv.launches = 0
        t0 = time.time()
        res = backend.optimize(m)
        secs = time.time() - t0
    finally:
        block_tridiag._chol_linv = k1
    return {"k1": "plain" if plain else "kernel", "status": res.status,
            "iterations": res.iter, "objective": res.objective,
            "solve_s": secs, "compared_dtype": str(dtype),
            "factorizations_of_dtype": calls[0],
            "k1_launches": chol_linv.launches,
            "host_returns": backend.solver.host_returns,
            "compare_first": cmp,
            "steps_cols": "f32,iter,status,mu,rr,delta_w,ls",
            "steps": backend.solver.log}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--compare", type=int, default=12)
    ap.add_argument("--factor-dtype", choices=("mixed", "float64"),
                    default="mixed")
    ap.add_argument("--max-iter", type=int, default=3000)
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for plain in (True, False):
        print(json.dumps(run(args.size, plain, args.compare,
                             args.factor_dtype, args.max_iter)), flush=True)


if __name__ == "__main__":
    main()
