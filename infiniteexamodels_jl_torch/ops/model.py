"""SimdModel: the frozen NLP with batched PyTorch evaluation sweeps.

ExaModel analogue (observed interface of the reference's upstream: ExaModel
fields theta/x0/lvar/uvar and the solution/multipliers API at
InfiniteExaModels.jl/src/infiniteopt_backend.jl:464-527).  All evaluation
methods are functions of ``(x, theta)``; each objective/constraint family
contributes one ``torch.func.vmap`` of its template (or of its ``grad``,
``hessian`` or ``jvp``) over the family's gathered rows.

Every scatter-add (gradient, Hessian-vector product, COO J products) runs
through a build-time gather + segment-sum plan (:mod:`.segsum`), so results
are bit-reproducible on CUDA, where ``index_add_`` sums with atomics.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch.func import grad, grad_and_value, hessian, jvp, vmap

from ..utils.device import resolve_device
from .compile import CompiledFamily
from .segsum import SegmentSum


class SimdModel:
    def __init__(self, core, dtype=None, device=None, row_pad=1):
        if int(row_pad) != 1:
            raise NotImplementedError(
                "row_pad (family padding for a device mesh) is not ported")
        self.core = core
        self.dtype = dtype or torch.float64
        self.device = resolve_device(device)
        self.sense = 1.0 if core.minimize else -1.0
        self.nvar = core.nvar
        self.ncon = core.ncon
        self.ntheta = core.ntheta

        self.con_fams = [
            CompiledFamily(f.expr, f.itr, offset=f.offset, name=f.name)
            for f in core.con_families
        ]
        self.obj_fams = [
            CompiledFamily(f.expr, f.itr, name=f.name)
            for f in core.obj_families
        ]

        if core.con_families:
            self._lcon_np = np.concatenate(
                [f.lcon for f in core.con_families])
            self._ucon_np = np.concatenate(
                [f.ucon for f in core.con_families])
        else:
            self._lcon_np = np.zeros(0)
            self._ucon_np = np.zeros(0)
        self.lcon = self._tensor(self._lcon_np)
        self.ucon = self._tensor(self._ucon_np)

        # device copies of the per-family static gather tables
        self._fam_dev = {}
        for fam in self.con_fams + self.obj_fams:
            self._fam_dev[id(fam)] = (
                torch.as_tensor(fam.vidx.astype(np.int64),
                                device=self.device),
                torch.as_tensor(fam.pidx.astype(np.int64),
                                device=self.device),
                self._tensor(fam.fdata),
            )
        # static sparsity patterns (numpy + device copies)
        self.jac_rows_np = (np.concatenate([f.jac_rows() for f in self.con_fams])
                            if self.con_fams else np.zeros(0, np.int64))
        self.jac_cols_np = (np.concatenate([f.jac_cols() for f in self.con_fams])
                            if self.con_fams else np.zeros(0, np.int64))
        hp = [f.hess_rows_cols() for f in self.con_fams + self.obj_fams]
        self.hess_rows_np = (np.concatenate([p[0] for p in hp]) if hp
                             else np.zeros(0, np.int64))
        self.hess_cols_np = (np.concatenate([p[1] for p in hp]) if hp
                             else np.zeros(0, np.int64))
        self.jac_rows = torch.as_tensor(self.jac_rows_np, device=self.device)
        self.jac_cols = torch.as_tensor(self.jac_cols_np, device=self.device)

        # deterministic scatter plans, one per destination pattern; the
        # value streams are concatenated in family order, so the per-slot
        # summation order is the family-by-family order of a sequential
        # scatter-add
        def vidx_stream(fams):
            parts = [f.vidx.reshape(-1) for f in fams if f.kx]
            return (np.concatenate(parts) if parts
                    else np.zeros(0, np.int64))

        self._grad_plan = SegmentSum(vidx_stream(self.obj_fams), self.nvar,
                                     self.device)
        self._hvp_plan = SegmentSum(
            vidx_stream(self.con_fams + self.obj_fams), self.nvar,
            self.device)
        self._jprod_plan = SegmentSum(self.jac_rows_np, self.ncon,
                                      self.device)
        self._jtprod_plan = SegmentSum(self.jac_cols_np, self.nvar,
                                       self.device)

        self.refresh_from_core()

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # -- mutable data ----------------------------------------------------
    def refresh_from_core(self):
        """Re-materialize x0/bounds/theta device arrays after host-side
        mutation of the core (start-value updates, parameter updates)."""
        c = self.core
        self._x0_np = None           # x0 == core.x0 again (see set_x0)
        self.x0 = self._tensor(c.x0)
        self.lvar = self._tensor(c.lvar)
        self.uvar = self._tensor(c.uvar)
        self.theta = self._tensor(c.theta)
        # warm-start multiplier storage (NLPModels get_y0 analogue,
        # reference InfiniteExaModels.jl/src/infiniteopt_backend.jl:600-601)
        if not hasattr(self, "y0") or self.y0.shape[0] != self.ncon:
            self.y0 = self._zeros(self.ncon)

    def set_parameter(self, par, values):
        """In-place theta update without rebuild (reference
        ExaModels.set_parameter! at infiniteopt_backend.jl:522-527)."""
        self.core.set_parameter(par, values)
        self.theta = self._tensor(self.core.theta)

    def set_x0(self, x0):
        # host twin kept for consts_fingerprint
        x0 = x0.detach().cpu().numpy() if torch.is_tensor(x0) else x0
        self._x0_np = np.asarray(x0, np.float64)
        self.x0 = self._tensor(self._x0_np)

    def set_y0(self, y0):
        y0 = y0.detach().cpu().numpy() if torch.is_tensor(y0) else y0
        self.y0 = self._tensor(y0)

    def consts_fingerprint(self):
        """Content hash of the mutable model data that enters the solver's
        problem constants (theta, x0, bounds); the solver caches its
        constants on it.  Hashes only host twins."""
        c = self.core
        x0 = self._x0_np if self._x0_np is not None else c.x0
        h = hashlib.blake2b(digest_size=16)
        for a in (c.theta, x0, c.lvar, c.uvar):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.digest()

    # -- family building block ------------------------------------------
    def _gather(self, fam, x, theta):
        vidx, pidx, fdata = self._fam_dev[id(fam)]
        return x[vidx], theta[pidx], fdata

    def _fam_vals(self, fam, x, theta):
        if fam.n == 0:
            return self._zeros(0)
        return vmap(fam.fn)(*self._gather(fam, x, theta))

    def _fam_grads(self, fam, x, theta):
        if fam.n == 0:
            return self._zeros(0, fam.kx)
        return vmap(grad(fam.fn))(*self._gather(fam, x, theta))  # (n, kx)

    def _fam_hess(self, fam, x, theta):
        if fam.n == 0:
            return self._zeros(0, fam.kx, fam.kx)
        return vmap(hessian(fam.fn))(*self._gather(fam, x, theta))

    def _fam_grad_and_value(self, fam, x, theta):
        if fam.n == 0:
            return self._zeros(0, fam.kx), self._zeros(0)
        return vmap(grad_and_value(fam.fn))(*self._gather(fam, x, theta))

    # -- evaluations (user sense; solvers fold in self.sense) ------------
    def obj(self, x, theta):
        total = self._zeros()
        for fam in self.obj_fams:
            total = total + torch.sum(self._fam_vals(fam, x, theta))
        return total

    def grad(self, x, theta):
        parts = [self._fam_grads(fam, x, theta).reshape(-1)
                 for fam in self.obj_fams if fam.kx]
        if not parts:
            return self._zeros(self.nvar)
        return self._grad_plan(torch.cat(parts))

    def cons(self, x, theta):
        if not self.con_fams:
            return self._zeros(0)
        return torch.cat([self._fam_vals(f, x, theta) for f in self.con_fams])

    # -- fused value+derivative sweeps (one vmapped pass per family) ------
    def obj_and_grad(self, x, theta):
        total = self._zeros()
        parts = []
        for fam in self.obj_fams:
            if fam.kx == 0:
                total = total + torch.sum(self._fam_vals(fam, x, theta))
                continue
            gv, v = self._fam_grad_and_value(fam, x, theta)
            total = total + torch.sum(v)
            parts.append(gv.reshape(-1))
        g = (self._grad_plan(torch.cat(parts)) if parts
             else self._zeros(self.nvar))
        return total, g

    def cons_and_jac(self, x, theta):
        vals, jparts = [], []
        for fam in self.con_fams:
            if fam.kx == 0:
                vals.append(self._fam_vals(fam, x, theta))
                continue
            gv, v = self._fam_grad_and_value(fam, x, theta)
            vals.append(v)
            jparts.append(gv.reshape(-1))
        cval = torch.cat(vals) if vals else self._zeros(0)
        jvals = torch.cat(jparts) if jparts else self._zeros(0)
        return cval, jvals

    def jac_vals(self, x, theta):
        """Values matching (jac_rows, jac_cols)."""
        parts = [self._fam_grads(fam, x, theta).reshape(-1)
                 for fam in self.con_fams if fam.kx]
        return torch.cat(parts) if parts else self._zeros(0)

    def _lam_slice(self, lam, fam):
        return lam[fam.offset:fam.offset + fam.n]

    def hess_vals(self, x, theta, lam, sigma):
        """Lagrangian Hessian COO values (full symmetric pattern
        hess_rows/cols): sigma * H(obj) + sum_i lam_i * H(c_i).

        NOTE the concat order is con families then obj families, matching
        the pattern construction in __init__."""
        parts = []
        for fam in self.con_fams:
            if fam.kx:
                H = self._fam_hess(fam, x, theta)
                w = self._lam_slice(lam, fam)
                parts.append((w[:, None, None] * H).reshape(-1))
        for fam in self.obj_fams:
            if fam.kx:
                parts.append((sigma * self._fam_hess(fam, x, theta))
                             .reshape(-1))
        return torch.cat(parts) if parts else self._zeros(0)

    def hvp_lag(self, x, theta, lam, sigma, v):
        """Lagrangian Hessian-vector product
        ``(sigma * H_f + sum_i lam_i * H_{c_i}) @ v`` without materializing
        any Hessian values: per family one vmapped jvp-of-grad sweep over
        the row-gathered slices of ``v`` (cost ~2 gradient sweeps)."""
        parts = []
        for fam in self.con_fams + self.obj_fams:
            if fam.kx == 0 or fam.n == 0:
                continue
            xg, pg, fv = self._gather(fam, x, theta)
            vg = v[self._fam_dev[id(fam)][0]]              # (n, kx)

            def hvp_row(xr, vr, pr, fr, fn=fam.fn):
                g = lambda z: grad(fn)(z, pr, fr)          # noqa: E731
                return jvp(g, (xr,), (vr,))[1]

            Hv = vmap(hvp_row)(xg, vg, pg, fv)             # (n, kx)
            if fam.offset is None:                         # objective
                w = torch.as_tensor(sigma, dtype=Hv.dtype,
                                    device=Hv.device).expand(fam.n)
            else:
                w = self._lam_slice(lam, fam).to(Hv.dtype)
            parts.append((w[:, None] * Hv).reshape(-1))
        if not parts:
            return torch.zeros(self.nvar, dtype=v.dtype, device=v.device)
        return self._hvp_plan(torch.cat(parts))

    def kkt_vals(self, x, theta, lam, sigma, d):
        """COO values of the condensed-KKT sparse part
        ``sigma*H_f + sum lam_i H_ci + J^T diag(d) J`` on the Hessian
        pattern: per con family the rank-1 ``d_r g_r g_r^T`` has exactly the
        family's square slot pattern, so it fuses into the same values."""
        parts = []
        for fam in self.con_fams:
            if fam.kx == 0:
                continue
            H = self._fam_hess(fam, x, theta)
            g = self._fam_grads(fam, x, theta)
            w = self._lam_slice(lam, fam)
            dr = self._lam_slice(d, fam)
            M = w[:, None, None] * H + dr[:, None, None] * (
                g[:, :, None] * g[:, None, :])
            parts.append(M.reshape(-1))
        for fam in self.obj_fams:
            if fam.kx == 0:
                continue
            H = self._fam_hess(fam, x, theta)
            parts.append((sigma * H).reshape(-1))
        return torch.cat(parts) if parts else self._zeros(0)

    # -- COO matvec helpers ----------------------------------------------
    def jprod(self, jvals, v):
        return self._jprod_plan(jvals * v[self.jac_cols])

    def jtprod(self, jvals, w):
        return self._jtprod_plan(jvals * w[self.jac_rows])

    def jac_row_absmax(self, jvals):
        """Per-constraint-row max |J| (0 for rows without entries)."""
        return self._jprod_plan(torch.abs(jvals), reduce="amax")

    # -- solution extraction ---------------------------------------------
    @staticmethod
    def _host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)

    def solution(self, xflat, var):
        """Reshape a flat solution slice to a variable's support grid
        (ExaModels.solution analogue, infiniteopt_backend.jl:464)."""
        seg = self._host(xflat)[var.offset:var.offset + var.length]
        return seg.reshape(var.shape) if var.shape else float(seg[0])

    def theta_view(self, par):
        seg = self._host(self.theta)[par.offset:par.offset + par.length]
        return seg.reshape(par.shape) if par.shape else float(seg[0])

    def multipliers(self, yflat, fam):
        return self._host(yflat)[fam.offset:fam.offset + len(fam)]
