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

On a CUDA model that holds all its rows (no mesh), each of the five
spanned sweeps (``obj``, ``cons``, ``obj_and_grad``, ``cons_and_jac``,
``kkt_vals``) runs as a CUDA graph (``utils/cuda_graphs.py``): captured on
its first call for each shape and dtype of its arguments, replayed after.  A
sweep is some thousands of small kernels launched one at a time through
``torch.func``'s interpreters, and every input a sweep depends on besides
its arguments is fixed once the rows are placed (gather tables, segment-sum
plans, the templates, which hold no host reads), so a replay launches the
same kernels in the same order and returns the eager result bit for bit.
A sharded model's sweeps all-gather over the mesh and stay eager, as does
everything on the CPU.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch.func import grad, grad_and_value, hessian, jvp, vmap

from ..utils.cuda_graphs import GraphCache
from ..utils.device import resolve_device
from ..utils.timers import spanned
from .compile import CompiledFamily
from .segsum import SegmentSum


# the AD sweeps' graph counters: captures, replays and eager sweeps
AD_COUNTERS = ("ad.graph_captures", "ad.graph_replays", "ad.eager_sweeps")


class SimdModel:
    def __init__(self, core, dtype=None, device=None, row_pad=1):
        self.core = core
        self.dtype = dtype or torch.float64
        self.device = resolve_device(device)
        self.sense = 1.0 if core.minimize else -1.0
        self.nvar = core.nvar
        self.ncon = core.ncon
        self.ntheta = core.ntheta
        # family rows are padded up to a multiple of ``row_pad`` (repeating
        # row 0's static data: no new pattern entries) so every family can
        # be shared out over a mesh whatever its logical row count; padded
        # rows are evaluated with the rest and never reach an output
        self.row_pad = max(int(row_pad), 1)
        self.mesh = None

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

        # host copies of the per-family static gather tables, padded
        self._fam_host = {}
        for fam in self.con_fams + self.obj_fams:
            tabs = (fam.vidx.astype(np.int64), fam.pidx.astype(np.int64),
                    fam.fdata)
            extra = -fam.n % self.row_pad if fam.n else 0
            if extra:
                tabs = tuple(np.concatenate([t, np.repeat(t[:1], extra, 0)])
                             for t in tabs)
            self._fam_host[id(fam)] = tabs
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
        self._jprod_plan = SegmentSum(self.jac_rows_np, self.ncon,
                                      self.device)
        self._jtprod_plan = SegmentSum(self.jac_cols_np, self.nvar,
                                       self.device)

        # the streams every output is finished from (see _place), and the
        # deterministic scatter plans of the sums; a stream concatenates
        # its families in order, so the per-slot summation order is the
        # family-by-family order of a sequential scatter-add
        def vidx_stream(fams):
            parts = [f.vidx.reshape(-1) for f in fams if f.kx]
            return (np.concatenate(parts) if parts
                    else np.zeros(0, np.int64))

        self._grad_plan = SegmentSum(vidx_stream(self.obj_fams), self.nvar,
                                     self.device)
        self._hvp_plan = SegmentSum(
            vidx_stream(self.con_fams + self.obj_fams), self.nvar,
            self.device)
        fams = self.con_fams + self.obj_fams
        obj = [(f, 1) for f in self.obj_fams]
        grad_ = [(f, f.kx) for f in self.obj_fams if f.kx]
        cons = [(f, 1) for f in self.con_fams]
        jac = [(f, f.kx) for f in self.con_fams if f.kx]
        self._stream_specs = {
            "obj": obj, "grad": grad_, "obj_grad": obj + grad_,
            "cons": cons, "jac": jac, "cons_jac": cons + jac,
            "hvp": [(f, f.kx) for f in fams if f.kx],
            "hess": [(f, f.kx * f.kx) for f in fams if f.kx]}
        self._place(None)
        self.refresh_from_core()

    # -- row placement ---------------------------------------------------
    def padded_rows(self, fam):
        return len(self._fam_host[id(fam)][0])

    def shard(self, mesh):
        """Keep only this rank's rows of every family (see
        ``parallel.shard_model``)."""
        if mesh.device != self.device:
            raise ValueError(f"mesh device {mesh.device} is not the "
                             f"model's {self.device}")
        self._place(mesh)

    def _place(self, mesh):
        """Put this rank's rows of each family on the device.

        Without a mesh every row is local.  Over a mesh, rank r holds the
        r-th contiguous slice of each family's padded rows; a family whose
        padded count does not divide the mesh is held whole by rank 0.
        ``_rows[id(fam)] = (lo, hi, valid, chunk)``: the local rows are
        ``[lo, hi)`` of the padded table, the first ``valid`` of them real,
        and ``chunk`` is every rank's share in the all-gather of a stream.

        Every output is finished from a *stream*, the per-row values of
        the real rows of its families in family order: constraint values,
        Jacobian and Hessian COO values are streams themselves, and the
        sums (objective, gradient, Hessian-vector product) are taken of a
        stream by the single-device segment-sum plans.  Over a mesh each
        rank evaluates its rows, one ``all_gather`` brings every rank's
        values, and a precomputed index puts them in row order (exact: a
        value is copied, never summed); every rank then finishes as one
        device would, so a sharded model's outputs are the unsharded
        model's bit for bit, on every rank.  (Summing per-rank partials
        over the ranks instead would round differently from the one-device
        order, and the degenerate stochastic programs amplify that into
        another iterate sequence.)"""
        self.mesh = mesh
        # the graphs read the gather tables placed below: captured anew
        self._graphs = GraphCache(self.device, mesh, *AD_COUNTERS)
        nd, r = (1, 0) if mesh is None else (mesh.size, mesh.rank)
        self._rows = {}
        self._fam_dev = {}
        for fam in self.con_fams + self.obj_fams:
            vidx, pidx, fdata = self._fam_host[id(fam)]
            n_pad = len(vidx)
            if nd == 1:
                lo, hi, chunk = 0, n_pad, n_pad
            elif n_pad and n_pad % nd == 0:
                chunk = n_pad // nd
                lo, hi = r * chunk, (r + 1) * chunk
            else:
                chunk = n_pad
                lo, hi = 0, (n_pad if r == 0 else 0)
            valid = max(0, min(hi, fam.n) - lo)
            self._rows[id(fam)] = (lo, hi, valid, chunk)
            self._fam_dev[id(fam)] = (
                torch.as_tensor(vidx[lo:hi], device=self.device),
                torch.as_tensor(pidx[lo:hi], device=self.device),
                self._tensor(fdata[lo:hi]),
            )
        self._padded = any(self._nloc(f) != self._rows[id(f)][2]
                           for f in self.con_fams + self.obj_fams)
        self._stream_order = {}
        if mesh is not None:
            for key, spec in self._stream_specs.items():
                self._stream_order[key] = torch.as_tensor(
                    self._gather_order(spec, nd), device=self.device)

    def _gather_order(self, spec, nd):
        """Positions, in the flattened all-gather of a stream's per-rank
        buffers, of the stream's values in row order."""
        chunks = [self._rows[id(f)][3] * w for f, w in spec]
        total = sum(chunks)
        out, off = [], 0
        for (f, w), ch in zip(spec, chunks):
            g = np.arange(f.n)
            chunk = self._rows[id(f)][3]
            if nd > 1 and chunk * nd == self.padded_rows(f):
                owner, local = g // max(chunk, 1), g % max(chunk, 1)
            else:
                owner, local = np.zeros_like(g), g
            pos = owner * total + off + local * w
            out.append((pos[:, None] + np.arange(w)[None, :]).reshape(-1))
            off += ch
        return (np.concatenate(out) if out
                else np.zeros(0, np.int64)).astype(np.int64)

    def _nloc(self, fam):
        lo, hi, _, _ = self._rows[id(fam)]
        return hi - lo

    def _stream(self, key, parts):
        """The stream ``key`` (each family's values over all its real rows,
        in family order) from this rank's ``parts`` (one flat tensor per
        family of the stream, over the local rows)."""
        spec = self._stream_specs[key]
        if self.mesh is None:
            if self._padded:
                parts = [p[:self._rows[id(f)][2] * w]
                         for (f, w), p in zip(spec, parts)]
            return torch.cat(parts) if parts else self._zeros(0)
        if not parts:
            return self._zeros(0)
        buf = []
        for (f, w), p in zip(spec, parts):
            short = self._rows[id(f)][3] * w - p.numel()
            buf.append(torch.cat([p, p.new_zeros(short)]) if short else p)
        flat = self.mesh.all_gather(torch.cat(buf)).reshape(-1)
        return flat[self._stream_order[key]]

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
    def _gather(self, fam, x, theta, dtype=None):
        """The family's rows of ``x`` and ``theta`` and its fixed values,
        these cast to ``dtype`` when it is given."""
        vidx, pidx, fdata = self._fam_dev[id(fam)]
        if dtype is not None:
            fdata = fdata.to(dtype)
        return x[vidx], theta[pidx], fdata

    def _fam_vals(self, fam, x, theta):
        if self._nloc(fam) == 0:
            return self._zeros(0)
        return vmap(fam.fn)(*self._gather(fam, x, theta))

    def _fam_grads(self, fam, x, theta, dtype=None):
        if self._nloc(fam) == 0:
            return x.new_zeros((0, fam.kx))
        return vmap(grad(fam.fn))(*self._gather(fam, x, theta,
                                                dtype))  # (n, kx)

    def _fam_hess(self, fam, x, theta, dtype=None):
        if self._nloc(fam) == 0:
            return x.new_zeros((0, fam.kx, fam.kx))
        return vmap(hessian(fam.fn))(*self._gather(fam, x, theta, dtype))

    def _fam_grad_and_value(self, fam, x, theta):
        if self._nloc(fam) == 0:
            return self._zeros(0, fam.kx), self._zeros(0)
        return vmap(grad_and_value(fam.fn))(*self._gather(fam, x, theta))

    def _obj_total(self, vals):
        """The objective from its stream: each family's sum, added in
        family order."""
        total, off = self._zeros(), 0
        for fam in self.obj_fams:
            total = total + torch.sum(vals[off:off + fam.n])
            off += fam.n
        return total

    # -- evaluations (user sense; solvers fold in self.sense) ------------
    @spanned("ad.obj")
    def obj(self, x, theta):
        return self._graphs("obj", self._eager_obj, x, theta)

    def _eager_obj(self, x, theta):
        return self._obj_total(self._stream(
            "obj", [self._fam_vals(fam, x, theta) for fam in self.obj_fams]))

    def grad(self, x, theta):
        parts = [self._fam_grads(fam, x, theta).reshape(-1)
                 for fam in self.obj_fams if fam.kx]
        if not parts:
            return self._zeros(self.nvar)
        return self._grad_plan(self._stream("grad", parts))

    @spanned("ad.cons")
    def cons(self, x, theta):
        return self._graphs("cons", self._eager_cons, x, theta)

    def _eager_cons(self, x, theta):
        return self._stream("cons", [self._fam_vals(f, x, theta)
                                     for f in self.con_fams])

    # -- fused value+derivative sweeps (one vmapped pass per family) ------
    @spanned("ad.obj_and_grad")
    def obj_and_grad(self, x, theta):
        return self._graphs("obj_and_grad", self._eager_obj_and_grad, x, theta)

    def _eager_obj_and_grad(self, x, theta):
        vals, parts = [], []
        for fam in self.obj_fams:
            if fam.kx == 0:
                vals.append(self._fam_vals(fam, x, theta))
                continue
            gv, v = self._fam_grad_and_value(fam, x, theta)
            vals.append(v)
            parts.append(gv.reshape(-1))
        both = self._stream("obj_grad", vals + parts)
        nobj = sum(f.n for f in self.obj_fams)
        g = (self._grad_plan(both[nobj:]) if parts
             else self._zeros(self.nvar))
        return self._obj_total(both[:nobj]), g

    @spanned("ad.cons_and_jac")
    def cons_and_jac(self, x, theta):
        return self._graphs("cons_and_jac", self._eager_cons_and_jac, x, theta)

    def _eager_cons_and_jac(self, x, theta):
        vals, jparts = [], []
        for fam in self.con_fams:
            if fam.kx == 0:
                vals.append(self._fam_vals(fam, x, theta))
                continue
            gv, v = self._fam_grad_and_value(fam, x, theta)
            vals.append(v)
            jparts.append(gv.reshape(-1))
        both = self._stream("cons_jac", vals + jparts)
        return both[:self.ncon], both[self.ncon:]

    def jac_vals(self, x, theta):
        """Values matching (jac_rows, jac_cols)."""
        return self._stream("jac", [self._fam_grads(fam, x, theta)
                                    .reshape(-1)
                                    for fam in self.con_fams if fam.kx])

    def _lam_slice(self, lam, fam):
        """``lam`` over the family's local rows (zero on padded ones)."""
        lo, hi, valid, _ = self._rows[id(fam)]
        w = lam[fam.offset + lo:fam.offset + lo + valid]
        return torch.cat([w, w.new_zeros(hi - lo - valid)]) \
            if hi - lo > valid else w

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
        return self._stream("hess", parts)

    @spanned("ad.hvp")
    def hvp_lag(self, x, theta, lam, sigma, v):
        """Lagrangian Hessian-vector product
        ``(sigma * H_f + sum_i lam_i * H_{c_i}) @ v`` without materializing
        any Hessian values: per family one vmapped jvp-of-grad sweep over
        the row-gathered slices of ``v`` (cost ~2 gradient sweeps)."""
        parts = []
        for fam in self.con_fams + self.obj_fams:
            if fam.kx == 0:
                continue
            if self._nloc(fam) == 0:
                parts.append(v.new_zeros(0))
                continue
            xg, pg, fv = self._gather(fam, x, theta)
            vg = v[self._fam_dev[id(fam)][0]]              # (n, kx)

            def hvp_row(xr, vr, pr, fr, fn=fam.fn):
                g = lambda z: grad(fn)(z, pr, fr)          # noqa: E731
                return jvp(g, (xr,), (vr,))[1]

            Hv = vmap(hvp_row)(xg, vg, pg, fv)             # (n, kx)
            if fam.offset is None:                         # objective
                w = torch.as_tensor(sigma, dtype=Hv.dtype,
                                    device=Hv.device).expand(Hv.shape[0])
            else:
                w = self._lam_slice(lam, fam).to(Hv.dtype)
            parts.append((w[:, None] * Hv).reshape(-1))
        if not parts:
            return torch.zeros(self.nvar, dtype=v.dtype, device=v.device)
        return self._hvp_plan(self._stream("hvp", parts))

    @spanned("ad.kkt_vals")
    def kkt_vals(self, x, theta, lam, sigma, d, dtype=None):
        """COO values of the condensed-KKT sparse part
        ``sigma*H_f + sum lam_i H_ci + J^T diag(d) J`` on the Hessian
        pattern: per con family the rank-1 ``d_r g_r g_r^T`` has exactly the
        family's square slot pattern, so it fuses into the same values.

        ``dtype`` runs the whole Hessian sweep in that precision: the inputs
        and the families' fixed values are cast once, and the templates
        follow their operands (their constants are Python floats, which
        never promote a tensor).  The low-precision step sets assemble
        their KKT this way for an f32 factorization (a graph of its own)."""
        return self._graphs("kkt_vals", self._eager_kkt_vals, x, theta, lam,
                            sigma, d, dtype=dtype)

    def _eager_kkt_vals(self, x, theta, lam, sigma, d, dtype=None):
        if dtype is not None:
            x, theta, lam, d = (a.to(dtype) for a in (x, theta, lam, d))
            sigma = torch.as_tensor(sigma, dtype=dtype, device=x.device)
        parts = []
        for fam in self.con_fams:
            if fam.kx == 0:
                continue
            H = self._fam_hess(fam, x, theta, dtype)
            g = self._fam_grads(fam, x, theta, dtype)
            w = self._lam_slice(lam, fam)
            dr = self._lam_slice(d, fam)
            M = w[:, None, None] * H + dr[:, None, None] * (
                g[:, :, None] * g[:, None, :])
            parts.append(M.reshape(-1))
        for fam in self.obj_fams:
            if fam.kx == 0:
                continue
            H = self._fam_hess(fam, x, theta, dtype)
            parts.append((sigma * H).reshape(-1))
        if not parts:
            return x.new_zeros(0)
        return self._stream("hess", parts)

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
