"""Condensed-KKT systems.

The IPM reduces each Newton step to a symmetric positive-definite (after
regularization) system in the primal x variables only:

    K = W + Sigma_x + delta_w I + J^T D J,    K dx = rhs

(the LiftedKKT-style condensation of the GPU IPM literature; the reference's
pipeline obtains the same effect via MadNLP+CUDSS, README.md:36-41).  The
sparse part of K is assembled directly from per-family COO values
(`SimdModel.kkt_vals`) -- the J^T D J term has exactly the per-family square
slot pattern of the Hessian, so no sparse matmul ever materializes.

Backends:
- :class:`DenseKKT` -- deterministic gather + segment-sum into a dense
  (n, n) matrix; Cholesky via ``torch.linalg.cholesky_ex``.  Right for
  small/medium n and the correctness oracle path.
- :class:`BlockTridiagKKT` (solvers/block_tridiag.py) -- exploits the
  block-tridiagonal + arrowhead structure of transcribed OCP/SP problems.
"""
from __future__ import annotations

import torch

from ..ops.segsum import SegmentSum


class DenseKKT:
    """Dense condensed KKT backend."""

    def __init__(self, model):
        self.model = model
        self.n = model.nvar
        self._plan = SegmentSum(
            model.hess_rows_np * self.n + model.hess_cols_np,
            self.n * self.n, model.device)

    def assemble(self, x, theta, lam, sigma, d, diag_extra):
        """K = sigma*Hf + sum lam_i Hc_i + J^T diag(d) J + diag(diag_extra).

        diag_extra carries Sigma_x + delta_w."""
        vals = self.model.kkt_vals(x, theta, lam, sigma, d)
        K = self._plan(vals).reshape(self.n, self.n)
        return K + torch.diag(diag_extra)

    def factor(self, K):
        # cholesky_ex, not cholesky: a matrix that is not SPD must come back
        # as ok=False for the regularization ladder, not as an exception;
        # its factor is NaN, as the reference's, so nothing downstream
        # mistakes the partial factor for a usable one
        L, info = torch.linalg.cholesky_ex(K)
        L = torch.where(info != 0, torch.nan, L)
        ok = (info == 0) & torch.isfinite(L).all()
        return L, ok

    def solve(self, L, rhs):
        z = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
        return torch.linalg.solve_triangular(L.T, z, upper=True)[:, 0]

    def matvec(self, K, v):
        return K @ v
