"""The f64 blocks of one solve on the card that K1 factors and its plain
version rejects, each characterized.

    python -m infiniteexamodels_jl_torch.tools.k1_plain_only --model quad --size 16000
    python -m infiniteexamodels_jl_torch.tools.k1_plain_only --model kinetic_control --size 50 --max-iter 600
    python -m infiniteexamodels_jl_torch.tools.k1_plain_only --model quad --size 12 --device cpu

Solves ``<model>(num_supports=size)`` through ``ExaTranscriptionBackend(
IpmSolver, linear_solver="auto", tol=1e-6)`` on the card with a hook
around ``block_tridiag._chol_linv`` (as chip_smoke's f64 census; nothing
in the package changes): every f64 call's blocks also go through the
plain version's test (LAPACK's, ``cholesky_ex``), and the solve goes on
with K1's result.  For each block that only the plain version rejects
(the call then waits for the card: a diagnostic) it prints one JSON line:
the call, ``n``, the pivot where LAPACK stopped (``info``, 1-based), K1's
pivot there and its least pivot (both over ``u D_jj``), the block's least
and greatest eigenvalue over its largest diagonal entry, those of the
block scaled to a unit diagonal and of its leading part before that
pivot, the spread of its diagonal, and the host CPU's LAPACK verdict on
the same block.  The card's name and power limit come first (on the
card), the solve's status, iterations, objective and counts last.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from .. import models
from ..backend import ExaTranscriptionBackend
from ..solvers import IpmSolver, block_tridiag


def _eig_range(S):
    """[least, greatest] eigenvalue of a symmetric matrix."""
    lam = torch.linalg.eigvalsh(S)
    return [float(lam[0]), float(lam[-1])]


def characterize(D, L, info):
    """One block ``D`` that K1 factored into ``L`` and LAPACK rejected at
    the leading minor of order ``info``."""
    u = torch.finfo(D.dtype).eps / 2
    d = torch.diagonal(D)
    piv = torch.diagonal(L) ** 2 / d / u
    j = info - 1
    s = d.rsqrt()
    S = s[:, None] * D * s[None, :]
    return {"n": D.shape[-1], "lapack_stopped_at": info,
            "k1_pivot_there_u": float(piv[j]),
            "k1_least_pivot_u": float(piv.min()),
            "eig_over_max_diag": [v / float(d.max()) for v in _eig_range(D)],
            "scaled_eig": _eig_range(S),
            "scaled_eig_leading": _eig_range(S[:j, :j]) if j > 0 else None,
            "diag_spread": float(d.max() / d.min()),
            "host_lapack_fails": bool(
                torch.linalg.cholesky_ex(D.cpu()).info != 0)}


def run(model, size, max_iter, device=None):
    k1 = block_tridiag._chol_linv
    calls, found = [0], []

    def hook(D):
        out = k1(D)
        if D.dtype == torch.float64:
            calls[0] += 1
            D = D.contiguous()
            info = torch.linalg.cholesky_ex(D).info
            only = (info != 0) & torch.isfinite(out[0]).flatten(1).all(1)
            for b in only.nonzero().flatten().tolist():
                rec = characterize(D[b], out[0][b], int(info[b]))
                found.append(rec)
                print(json.dumps({"call": calls[0], "block": b, **rec}),
                      flush=True)
        return out

    block_tridiag._chol_linv = hook
    try:
        m = getattr(models, model)(num_supports=size)
        backend = ExaTranscriptionBackend(IpmSolver, device=device,
                                          linear_solver="auto", tol=1e-6,
                                          max_iter=max_iter, print_level=0)
        m.set_transformation_backend(backend)
        res = backend.optimize(m)
    finally:
        block_tridiag._chol_linv = k1
    return {"model": model, "size": size, "status": res.status,
            "iterations": res.iter, "objective": res.objective,
            "f64_calls": calls[0], "plain_only_blocks": len(found)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="quad")
    ap.add_argument("--size", type=int, default=16000)
    ap.add_argument("--max-iter", type=int, default=3000)
    ap.add_argument("--device", default=None,
                    help="cpu for the host (where K1 is its plain version)")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    print(json.dumps(run(args.model, args.size, args.max_iter,
                         args.device)))


if __name__ == "__main__":
    main()
