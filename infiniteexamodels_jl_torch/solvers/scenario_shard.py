"""Mesh-aligned scenario-parallel condensed-KKT backend.

Each rank of a :class:`~..parallel.Mesh` assembles, factors and solves only
its own scenario blocks:

- build time (numpy): every family row is mapped to the (unique) scenario
  block its variables live in -- a row touches one block, else the
  connected-component analysis would have merged the blocks.  Blocks are
  dealt to the ranks contiguously (``nb_loc = nb / size`` each), and each
  rank keeps the rows of its own blocks with every COO entry's target as a
  flat index into its buffer ``[D_local | B_local | C_partial]``.
- run time: each rank evaluates only its own rows (gathering from the
  replicated iterate), sums them into only its own blocks (a segment-sum
  plan, deterministic) and factors only its own blocks with K1.  The
  collectives left are the ones the arrowhead needs: the sum over the ranks
  of the dense Schur corner ``S = C - sum_b B_b^T T_b^-1 B_b`` (mB x mB,
  with the ranks' failure count in the same message), of the border's
  right-hand side (mB), and the one all-gather that hands a solution in
  T-layout back to the replicated iterate -- all O(border) except that
  last, none O(nnz).

The constraint and variable order users see is untouched: the per-rank
tables are private copies used only for KKT assembly.  Where the layout
does not apply (:attr:`aligned` false) the class is its parent,
:class:`~.block_tridiag.BlockTridiagKKT`, run whole on every rank.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, hessian, vmap

from ..ops.segsum import SegmentSum
from .block_tridiag import BlockTridiagKKT, _apply_inv, _chol_linv


class TLayoutOps:
    """T-layout vectors, shared by the aligned sharded backends.

    A T-layout vector is the pair ``(xT, xB)``: ``xT`` this rank's
    ``nb_loc*bs`` block slots (padding slots identically zero) and ``xB``
    the replicated border part ``(mB,)``.  ``solve_tl``/``matvec_tl``
    work in this layout with O(border) and O(halo) collectives only, so
    the IPM's iterative refinement moves nothing O(n) per round; the one
    O(n) collective per step direction is :meth:`tl_scatter`'s all-gather
    handing the finished step back to the replicated iterate."""

    tlayout = False     # set True by the aligned builders

    def _build_tlayout(self, rank):
        """This rank's slot -> variable tables; ``_dev_of_t`` is the rank
        owning each T variable (in ``t_ids`` order)."""
        t_ids = self.t_ids_np
        t_slots = self._slot_np[t_ids]
        sel = np.nonzero(self._dev_of_t == rank)[0]
        as_t = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        self._tl_loc = as_t(t_slots[sel] - rank * self.nb_loc * self.bs)
        self._tl_ids = as_t(t_ids[sel])
        # in the all-gather of every rank's slots, variable t_ids[k] sits
        # at its padded slot t_slots[k]
        self._tl_all_ids = as_t(t_ids)
        self._tl_all_slots = as_t(t_slots)

    def tl_gather(self, rhs):
        """Replicated ``(n,)`` vector -> T-layout pair, without a
        collective: each rank picks its own slots."""
        xT = rhs.new_zeros(self.nb_loc * self.bs)
        xT[self._tl_loc] = rhs[self._tl_ids]
        return xT, rhs[self.b_ids]

    def tl_scatter(self, x):
        """T-layout pair -> replicated ``(n,)`` vector: one all-gather of
        the T part (the only O(n) collective of the step path)."""
        xT, xB = x
        g = self.mesh.all_gather(xT).reshape(-1)
        out = xT.new_zeros(self.n)
        out[self._tl_all_ids] = g[self._tl_all_slots]
        out[self.b_ids] = xB
        return out

    def tl_add(self, a, b):
        return a[0] + b[0], a[1] + b[1]

    def tl_sub(self, a, b):
        return a[0] - b[0], a[1] - b[1]

    def tl_where(self, pred, a, b):
        return torch.where(pred, a[0], b[0]), torch.where(pred, a[1], b[1])

    def tl_norm(self, a):
        """2-norm of a T-layout vector: the replicated norm, since padding
        slots are zero and the border is replicated.  A local partial sum
        and one scalar psum."""
        xT, xB = a
        return torch.sqrt(self.mesh.psum_scalar(torch.sum(xT * xT))
                          + torch.sum(xB * xB))


class _NotAlignable(Exception):
    pass


def _family_tables(model, rows_of, device):
    """Per family with variables: the rows ``rows_of(fam)`` returns (of the
    unpadded family), their gather tables on ``device`` and whether the
    family is a constraint family (weighted by ``lam``).  Families with no
    row here are left out."""
    out = []
    for fam in model.con_fams + model.obj_fams:
        if fam.kx == 0:
            continue
        rows = rows_of(fam)
        if len(rows) == 0:
            continue
        has_lam = fam.offset is not None
        out.append((fam, rows, has_lam, (
            torch.as_tensor(fam.vidx[rows].astype(np.int64), device=device),
            torch.as_tensor(fam.pidx[rows].astype(np.int64), device=device),
            torch.as_tensor(fam.fdata[rows], dtype=model.dtype,
                            device=device),
            torch.as_tensor(fam.offset + rows if has_lam else rows,
                            device=device))))
    return out


def _local_kkt_values(tables, x, theta, lam, sigma, d):
    """The condensed-KKT COO values of this rank's rows, family by family
    (the per-family square patterns of ``SimdModel.kkt_vals``)."""
    parts = []
    for fam, _, has_lam, (vidx, pidx, fdata, lam_src) in tables:
        fdata = fdata.to(x.dtype)
        xg, pg = x[vidx], theta[pidx]
        H = vmap(hessian(fam.fn))(xg, pg, fdata)
        if has_lam:
            g = vmap(grad(fam.fn))(xg, pg, fdata)
            M = lam[lam_src][:, None, None] * H + d[lam_src][:, None, None] * (
                g[:, :, None] * g[:, None, :])
        else:
            M = sigma * H
        parts.append(M.reshape(-1))
    return torch.cat(parts) if parts else x.new_zeros(0)


def _cast_inputs(fdt, x, theta, lam, sigma, d, diag_extra):
    """The assembly's inputs in ``fdt`` (the low-precision step sets), or
    as given."""
    if fdt is None:
        return x, theta, lam, sigma, d, diag_extra
    x, theta, lam, d, diag_extra = (a.to(fdt) for a in
                                    (x, theta, lam, d, diag_extra))
    return (x, theta, lam, torch.as_tensor(sigma, dtype=fdt,
                                           device=x.device), d, diag_extra)


class _AlignedKKT(TLayoutOps):
    """What the aligned scenario and band backends share: this rank's
    assembly buffer and the border (arrowhead) steps, whose only
    collectives are O(mB^2) and O(mB) sums over the ranks.  A subclass
    builds ``_al_tabs``, ``_asm_plan``, ``_dg_src``/``_dg_dst`` and
    ``_pad_dst``."""

    # the parent's device tables over the whole system (its assembly
    # plans, the padding identity of every block, the slot permutations),
    # which the aligned path never reads: it assembles, factors and solves
    # only this rank's blocks.  Kept, they would make every rank hold as
    # much as one device does (quad-1000: the padding identity alone is
    # 1,024 blocks of 64 x 64, 33.6 MB)
    WHOLE_SYSTEM_TABLES = ("D_plan", "L_plan", "B_plan", "C_plan",
                           "pad_eye", "diag_take", "diag_dest", "slot_src",
                           "slot_mask", "out_perm")

    def _release_whole_system_tables(self):
        for name in self.WHOLE_SYSTEM_TABLES:
            setattr(self, name, None)

    def _local_buffer(self, x, theta, lam, sigma, d, diag_extra):
        """This rank's assembled buffer (rows, diagonal, padding)."""
        x, theta, lam, sigma, d, diag_extra = _cast_inputs(
            self.assemble_dtype, x, theta, lam, sigma, d, diag_extra)
        vals = _local_kkt_values(self._al_tabs, x, theta, lam, sigma, d)
        buf = self._asm_plan(vals)
        # unique destinations: plain indexed adds, deterministic
        buf[self._dg_dst] += diag_extra[self._dg_src]
        buf[self._pad_dst] += 1.0
        return buf, diag_extra

    def _border_corner(self, Cp, diag_extra):
        if not self.mB:
            return Cp
        return self.mesh.psum(Cp) + torch.diag(diag_extra[self.b_ids])

    def _border_factor(self, C, BZ, ok):
        """``S = C - sum over the ranks of B^T Z`` and its Cholesky factor,
        with every rank's K1 failures summed in the same message; ``ok``
        is then the same on every rank."""
        bad = (~ok).to(C.dtype).reshape(1)
        if not self.mB:
            nbad = self.mesh.psum_scalar(bad[0])
            return C.new_zeros((0, 0)), nbad == 0
        red = self.mesh.psum(torch.cat([BZ.reshape(-1), bad]))
        S = C - red[:-1].reshape(self.mB, self.mB)
        Ls, info = torch.linalg.cholesky_ex(S)
        Ls = torch.where(info != 0, torch.nan, Ls)
        return Ls, (red[-1] == 0) & torch.isfinite(Ls).all()

    def _border_solve(self, Z, Ls, sB, u, rT, rB, dt):
        """The border part of a solve: ``x_B = S^{-1} (r_B - sum Z^T r_T)``
        and ``x_T = u - Z x_B``; returns (x_T, x_B) with x_B in ``dt``."""
        if not self.mB:
            return u, rB.new_zeros(0)
        rhs2 = (rB * sB).to(Z.dtype) - self.mesh.psum(
            torch.einsum("bij,bi->j", Z, rT))
        z2 = torch.linalg.solve_triangular(Ls, rhs2[:, None], upper=False)
        x2 = torch.linalg.solve_triangular(Ls.T, z2, upper=True)[:, 0]
        return u - torch.einsum("bij,j->bi", Z, x2), x2.to(dt) * sB

    def _border_matvec(self, B, C, vT, vB, oT, out_dt):
        if not self.mB:
            return oT, vB.new_zeros(0)
        vBd = vB.to(B.dtype)
        oT = oT + torch.einsum("bij,j->bi", B, vBd)
        oB = self.mesh.psum(torch.einsum("bij,bi->j", B, vT)) + C @ vBd
        return oT, oB.to(out_dt)


class ShardedScenarioKKT(_AlignedKKT, BlockTridiagKKT):
    """Block-diagonal scenario KKT with per-rank assembly and factoring.

    Falls back to the parent (every rank factors the whole system)
    whenever the aligned layout does not apply; check :attr:`aligned`."""

    def __init__(self, model, mesh=None, mesh_axis="sp", **kwargs):
        super().__init__(model, mesh=mesh, mesh_axis=mesh_axis, **kwargs)
        self.aligned = False
        mesh = self.mesh
        if not (getattr(self, "usable", False) and self.block_diag
                and mesh is not None):
            return
        nd = mesh.size
        if nd <= 1 or self.nb % nd:
            return
        try:
            self._build_aligned(model, nd, mesh.rank)
        except _NotAlignable:
            return
        self.aligned = True
        self.tlayout = True
        self._release_whole_system_tables()

    # ------------------------------------------------------------------
    def _build_aligned(self, model, nd, rank):
        nb, bs, mB = self.nb, self.bs, self.mB
        nb_loc = nb // nd
        self.nd, self.nb_loc = nd, nb_loc
        n = self.n
        t_ids, b_ids = self.t_ids_np, self.b_ids_np
        t_slots = self._slot_np[t_ids]
        blk = np.full(n, -1, np.int64)
        blk[t_ids] = t_slots // bs
        off = np.full(n, -1, np.int64)
        off[t_ids] = t_slots % bs
        bpos = np.full(n, -1, np.int64)
        bpos[b_ids] = np.arange(mB)

        # this rank's buffer [D_local | B_local | C_partial]
        szD, szB, szC = nb_loc * bs * bs, nb_loc * bs * mB, mB * mB
        self._szs = (szD, szB, szC)
        trash = szD + szB + szC

        def rows_of(fam):
            b = blk[fam.vidx]                              # (n, kx)
            has_t = b >= 0
            rowblk = np.where(has_t.any(1), b.max(1), -1)
            # all T variables of a row in one block
            if np.any(has_t & (b != rowblk[:, None])):
                raise _NotAlignable
            dev = np.where(rowblk >= 0, rowblk // nb_loc,
                           np.arange(fam.n) % nd)
            return np.nonzero(dev == rank)[0]

        self._al_tabs = _family_tables(model, rows_of, self.device)
        tgts = []
        for fam, rows, _, _ in self._al_tabs:
            va = fam.vidx[rows]                            # (R, kx)
            ba, oa, pa = blk[va], off[va], bpos[va]
            bl = ba - rank * nb_loc                        # local block
            A, Bc = ba[:, :, None], ba[:, None, :]
            blA = bl[:, :, None]
            oA, oB = oa[:, :, None], oa[:, None, :]
            pA, pB = pa[:, :, None], pa[:, None, :]
            tgt = np.full(A.shape[:1] + (fam.kx, fam.kx), trash, np.int64)
            tgt = np.where((A >= 0) & (Bc >= 0), (blA * bs + oA) * bs + oB,
                           tgt)
            if mB:
                tgt = np.where((A >= 0) & (Bc < 0),
                               szD + (blA * bs + oA) * mB + pB, tgt)
                tgt = np.where((A < 0) & (Bc < 0), szD + szB + pA * mB + pB,
                               tgt)
            tgts.append(tgt.reshape(-1))
        tgt = np.concatenate(tgts) if tgts else np.zeros(0, np.int64)
        keep = np.nonzero(tgt != trash)[0]
        self._asm_plan = SegmentSum(tgt[keep], trash, self.device, sel=keep,
                                    nnz_total=len(tgt))

        # diagonal additions: this rank's T variables -> its D diagonal
        self._dev_of_t = blk[t_ids] // nb_loc
        ids = t_ids[self._dev_of_t == rank]
        lb = blk[ids] - rank * nb_loc
        self._dg_src = torch.as_tensor(ids, device=self.device)
        self._dg_dst = torch.as_tensor((lb * bs + off[ids]) * bs + off[ids],
                                       device=self.device)
        # padding slots of this rank's blocks -> unit diagonal
        occ = np.zeros((nb, bs), bool)
        occ[t_slots // bs, t_slots % bs] = True
        pb, po = np.nonzero(~occ[rank * nb_loc:(rank + 1) * nb_loc])
        self._pad_dst = torch.as_tensor((pb * bs + po) * bs + po,
                                        device=self.device)
        self._build_tlayout(rank)

    # ------------------------------------------------------------------
    def assemble(self, x, theta, lam, sigma, d, diag_extra):
        if not self.aligned:
            return super().assemble(x, theta, lam, sigma, d, diag_extra)
        nb_loc, bs, mB = self.nb_loc, self.bs, self.mB
        szD, szB, szC = self._szs
        buf, diag_extra = self._local_buffer(x, theta, lam, sigma, d,
                                             diag_extra)
        D = buf[:szD].reshape(nb_loc, bs, bs)
        B = buf[szD:szD + szB].reshape(nb_loc, bs, mB)
        C = self._border_corner(buf[szD + szB:].reshape(mB, mB), diag_extra)
        return D, B, C

    # ------------------------------------------------------------------
    def factor(self, K):
        if not self.aligned:
            return super().factor(K)
        D, B, C = K
        mB = self.mB
        # Jacobi equilibration per block, as the parent's
        dg = torch.abs(torch.diagonal(D, dim1=-2, dim2=-1))
        sT = 1.0 / torch.sqrt(torch.clamp(dg, min=1e-30))
        D = D * sT[:, :, None] * sT[:, None, :]
        if mB:
            sB = 1.0 / torch.sqrt(torch.clamp(torch.abs(torch.diag(C)),
                                              min=1e-30))
            B = B * sT[:, :, None] * sB[None, None, :]
            C = C * sB[:, None] * sB[None, :]
        else:
            sB = D.new_zeros(0)
        fdt = self.factor_dtype
        if fdt is not None and fdt != D.dtype:
            D, B, C = D.to(fdt), B.to(fdt), C.to(fdt)
        # K1 on this rank's blocks
        _, Linv, ok = _chol_linv(D)
        if mB:
            Z = _apply_inv(Linv, B)
            BZ = torch.einsum("bij,bik->jk", B, Z)
        else:
            Z = BZ = D.new_zeros((self.nb_loc, self.bs, 0))
        Ls, ok = self._border_factor(C, BZ, ok)
        return (Linv, Z, Ls, sT, sB), ok

    # ------------------------------------------------------------------
    def solve_tl(self, fac, r):
        """Solve in T-layout: one O(mB) psum of the border right-hand side
        (nothing when mB == 0)."""
        Linv, Z, Ls, sT, sB = fac
        rT2, rB = r
        dt = rT2.dtype
        rT = (rT2.reshape(self.nb_loc, self.bs) * sT).to(Z.dtype)
        u = _apply_inv(Linv, rT[..., None])[..., 0]
        x1, xB = self._border_solve(Z, Ls, sB, u, rT, rB, dt)
        return (x1.to(dt) * sT).reshape(-1), xB

    def solve(self, fac, rhs):
        if not self.aligned:
            return super().solve(fac, rhs)
        return self.tl_scatter(self.solve_tl(fac, self.tl_gather(rhs)))

    # ------------------------------------------------------------------
    def matvec_tl(self, K, v):
        """K @ v in T-layout: one O(mB) psum for the border row."""
        D, B, C = K
        vT2, vB = v
        vT = vT2.reshape(self.nb_loc, self.bs).to(D.dtype)
        oT = torch.matmul(D, vT[..., None])[..., 0]
        oT, oB = self._border_matvec(B, C, vT, vB, oT, vT2.dtype)
        return oT.reshape(-1).to(vT2.dtype), oB

    def matvec(self, K, v):
        if not self.aligned:
            return super().matvec(K, v)
        return self.tl_scatter(self.matvec_tl(K, self.tl_gather(v)))
