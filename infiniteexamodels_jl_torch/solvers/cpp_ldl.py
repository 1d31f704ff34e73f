"""Sparse LDL^T on the host: the condensed KKT factored by ``csrc/ldl.cpp``.

The role Ipopt's MA27 plays in the reference (README.md:36-41): an
in-process sparse symmetric factorization on the CPU with exact inertia.
The condensed KKT's COO pattern is mapped once to a CSC upper triangle
under a reverse-Cuthill-McKee ordering and analysed symbolically; each
factorization moves the step's values to host memory, factors them
numerically there, and each solve hands its result back on the model's
device.  The library is compiled from the port's own source at first use
(:mod:`..utils.host_build`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.segsum import SegmentSum
from ..utils import host_build
from .kkt import CondensedKKT


def load_library():
    """The LDL library (built on first use) with its C signatures."""
    lib = host_build.load("ldl")
    I = ctypes.POINTER(ctypes.c_int64)      # noqa: E741
    Dp = ctypes.POINTER(ctypes.c_double)
    lib.ldl_symbolic.restype = ctypes.c_int64
    lib.ldl_symbolic.argtypes = [ctypes.c_int64, I, I, I, I, I]
    lib.ldl_numeric.restype = ctypes.c_int64
    lib.ldl_numeric.argtypes = [ctypes.c_int64, I, I, Dp, I, I, I, Dp, Dp,
                                I, Dp]
    lib.ldl_solve.restype = None
    lib.ldl_solve.argtypes = [ctypes.c_int64, I, I, Dp, Dp, Dp]
    return lib


def _ptr_i(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptr_d(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _host(t):
    return np.ascontiguousarray(t.detach().cpu().numpy(), dtype=np.float64)


class SparseLDL:
    """Symbolic + numeric LDL^T over a fixed sparsity pattern.

    A reverse-Cuthill-McKee permutation is applied to the pattern before
    the symbolic analysis (the role MA27's minimum-degree ordering plays in
    the reference's Ipopt path): the up-looking factorization fills within
    the profile, so the natural transcription order can explode on
    condensed KKTs that are not banded."""

    def __init__(self, n, rows, cols, order="rcm"):
        self.lib = load_library()
        self.n = n
        if order == "rcm" and n > 1:
            import scipy.sparse as sp
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            A = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                              shape=(n, n)).tocsr()
            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                              dtype=np.int64)
        else:
            perm = np.arange(n, dtype=np.int64)
        self.perm = perm
        self.iperm = np.empty(n, np.int64)
        self.iperm[perm] = np.arange(n)
        rows = self.iperm[np.asarray(rows)]
        cols = self.iperm[np.asarray(cols)]
        # upper-triangle CSC pattern (cols are CSC columns)
        r = np.minimum(rows, cols)
        c = np.maximum(rows, cols)
        order = np.lexsort((r, c))
        r, c = r[order], c[order]
        keep = np.ones(len(r), bool)
        keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        self.ur, self.uc = r[keep], c[keep]
        # every COO entry's deduplicated slot
        slot_of = np.cumsum(keep) - 1
        self.entry_slot = np.empty(len(rows), np.int64)
        self.entry_slot[order] = slot_of
        self.nnz = len(self.ur)
        self.Ap = np.zeros(n + 1, np.int64)
        np.add.at(self.Ap, self.uc + 1, 1)
        self.Ap = np.cumsum(self.Ap)
        self.Ai = self.ur.copy()
        self.Lp = np.zeros(n + 1, np.int64)
        self.parent = np.zeros(n, np.int64)
        work = np.zeros(n, np.int64)
        lnz = self.lib.ldl_symbolic(n, _ptr_i(self.Ap), _ptr_i(self.Ai),
                                    _ptr_i(self.Lp), _ptr_i(self.parent),
                                    _ptr_i(work))
        self.Li = np.zeros(max(lnz, 1), np.int64)
        self.Lx = np.zeros(max(lnz, 1), np.float64)
        self.D = np.zeros(n, np.float64)
        self._wi = np.zeros(3 * n, np.int64)
        self._wx = np.zeros(n, np.float64)
        self.diag_slots = None  # set by the caller for diagonal additions

    def factor(self, coo_vals, diag=None):
        """Numeric factorization of the COO values (plus ``diag`` on the
        diagonal slots); returns the count of nonpositive pivots, or -1-k
        on a zero pivot at column k."""
        Ax = np.zeros(self.nnz)
        np.add.at(Ax, self.entry_slot, coo_vals)
        # the COO stream carries the FULL symmetric matrix: each strictly
        # off-diagonal value arrives twice ((i,j) and (j,i)) and both land
        # on the same upper slot -- halve those
        Ax[self.ur != self.uc] *= 0.5
        if self.diag_slots is not None:
            Ax[self.diag_slots] += diag
        info = self.lib.ldl_numeric(
            self.n, _ptr_i(self.Ap), _ptr_i(self.Ai), _ptr_d(Ax),
            _ptr_i(self.Lp), _ptr_i(self.parent), _ptr_i(self.Li),
            _ptr_d(self.Lx), _ptr_d(self.D), _ptr_i(self._wi),
            _ptr_d(self._wx))
        return int(info)

    def solve(self, b, Lx=None, D=None):
        """``K^{-1} b`` from the last factorization, or from the factor
        values ``Lx``, ``D`` kept from an earlier one (the pattern ``Li``
        is the same for every factorization)."""
        Lx = self.Lx if Lx is None else Lx
        D = self.D if D is None else D
        # permuted system: K_p = P K P^T, so K x = b is K_p (P x) = P b
        x = np.ascontiguousarray(np.asarray(b, np.float64)[self.perm])
        self.lib.ldl_solve(self.n, _ptr_i(self.Lp), _ptr_i(self.Li),
                           _ptr_d(Lx), _ptr_d(D), _ptr_d(x))
        out = np.empty(self.n, np.float64)
        out[self.perm] = x
        return out


class CppLdlKKT(CondensedKKT):
    """Condensed-KKT backend on the host LDL.

    ``factor`` factors on the host and reports ``ok`` false when a pivot is
    nonpositive (wrong inertia for the SPD condensed system); ``solve``
    then returns NaN, as the reference's does, so the IPM's regularization
    ladder retries exactly as after a failed Cholesky.  The solve is exact
    (:meth:`refinement` is None): the IPM skips iterative refinement on
    it."""

    def __init__(self, model):
        self.model = model
        self.n = model.nvar
        rows, cols = model.hess_rows_np, model.hess_cols_np
        # every diagonal entry in the pattern (Sigma_x + delta_w lands there)
        diag = np.arange(self.n, dtype=np.int64)
        self.ldl = SparseLDL(self.n, np.concatenate([rows, diag]),
                             np.concatenate([cols, diag]))
        self.nentries = len(rows)
        self.ldl.diag_slots = self.ldl.entry_slot[self.nentries:]
        # K @ v on the device: a fixed-order segment sum over the rows
        self._rows_plan = SegmentSum(rows, self.n, model.device)
        self._cols = torch.as_tensor(cols, device=model.device)

    def assemble(self, x, theta, lam, sigma, d, diag_extra):
        vals = self.model.kkt_vals(x, theta, lam, sigma, d)
        return (vals, diag_extra)

    def factor(self, K):
        vals, diag = K
        info = self.ldl.factor(
            np.concatenate([_host(vals), np.zeros(self.n)]), _host(diag))
        # the factor values are kept with the result: a second solve (the
        # second-order correction) after another factorization stays right
        fac = (self.ldl.Lx.copy(), self.ldl.D.copy(), info)
        return fac, torch.as_tensor(info == 0, device=self.model.device)

    def solve(self, fac, rhs):
        Lx, D, info = fac
        if info != 0:      # nonpositive pivots or breakdown
            out = np.full(self.n, np.nan)
        else:
            out = self.ldl.solve(_host(rhs), Lx, D)
        return torch.as_tensor(out, dtype=rhs.dtype, device=self.model.device)

    def matvec(self, K, v):
        vals, diag = K
        return self._rows_plan(vals * v[self._cols]) + diag * v

    def refinement(self, fac, K):
        return None
