"""Mesh-distributed band (time-axis) condensed-KKT backend.

Time-block partitioning for transcribed optimal-control problems: the band
KKT

    K = [ T    B ]     T: nb tridiagonal blocks of size bs
        [ B^T  C ]     B: border (first-stage / high-degree) coupling

is split into ``size`` contiguous segments of ``nb_loc = nb / size``
blocks, with nb padded so that nb_loc is a power of two (padding blocks are
identity and decoupled).  Block cyclic reduction's odd/even elimination
then runs with the arithmetic of the single-device backend
(``block_tridiag._bcr_*``, Gram-form Schur updates included): each level
eliminates the local odd blocks with one K1 launch, and the only
dependence across a segment edge -- the eliminated boundary block couples
into the right neighbour's first survivor -- travels as an O(bs^2) halo,
two ring shifts per level.  After log2(nb_loc) levels one block per rank
survives; that chain of ``size`` blocks is all-gathered (O(size*bs^2)) and
finished on every rank by the replicated single-device BCR, with K1.

Per IPM step each rank:
  1. evaluates only its own rows (a row belongs to the rank owning its
     first time block) and sums them into its local D/E/B/C buffers; the
     spill of a boundary stencil into the next rank's first block travels
     as an O(bs^2 + bs*mB) halo;
  2. runs the local BCR levels with the per-level halo exchange;
  3. for the border: Z = T^{-1} B by the distributed solve, then one sum
     over the ranks of the O(mB^2) Schur corner, factored on every rank.

Collectives are O(bs^2 log nb_loc + size*bs^2 + mB^2) per factorization and
O(bs log nb_loc + size*bs + mB) per solve -- never O(nnz) -- except the
one O(n) all-gather that hands a step back to the replicated iterate.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.segsum import SegmentSum
from .block_tridiag import (BlockTridiagKKT, _apply_inv, _bcr_factor,
                            _bcr_solve, _chol_linv, _lsolve)
from .scenario_shard import _AlignedKKT, _family_tables


class _NotBandShardable(Exception):
    pass


def _pow2_segments(nd):
    """nb_round callable: nb -> nd * 2^ceil(log2(ceil(nb/nd)))."""
    def rnd(nb):
        per = max((nb + nd - 1) // nd, 1)
        return nd * int(2 ** np.ceil(np.log2(per)))
    return rnd


class ShardedBandKKT(_AlignedKKT, BlockTridiagKKT):
    """Band-mode condensed KKT with one time segment per rank.

    Falls back to the parent's single-device behaviour (every rank factors
    the whole system) when the layout does not apply; check
    :attr:`aligned`."""

    def __init__(self, model, mesh=None, mesh_axis="sp", **kwargs):
        mesh_ = mesh if mesh is not None else getattr(model, "mesh", None)
        if mesh_ is not None and mesh_.size > 1:
            kwargs.setdefault("nb_round", _pow2_segments(mesh_.size))
        super().__init__(model, mesh=mesh, mesh_axis=mesh_axis, **kwargs)
        self.aligned = False
        mesh = self.mesh
        if not (getattr(self, "usable", False)
                and getattr(self, "mode", None) == "band"
                and not self.block_diag and mesh is not None):
            return
        nd = mesh.size
        if nd <= 1 or self.nb % nd:
            return
        nb_loc = self.nb // nd
        if nb_loc & (nb_loc - 1):          # must be a power of two
            return
        try:
            self._build_aligned(model, nd, mesh.rank)
        except _NotBandShardable:
            return
        self.aligned = True
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

        # this rank's buffer:
        #   [D (nb_loc,bs,bs) | E (nb_loc,bs,bs) | B (nb_loc*bs,mB) |
        #    C (mB,mB) | haloD (bs,bs) | haloE (bs,bs) | haloB (bs,mB)]
        # E[k] couples local block k (rows) to block k-1 (columns); E[0] is
        # the coupling to the LEFT neighbour's last block, owned by this
        # rank and filled by the halo shift (zero on rank 0)
        szD = szE = nb_loc * bs * bs
        szB, szC = nb_loc * bs * mB, mB * mB
        oE, oB_, oC = szD, szD + szE, szD + szE + szB
        oHD = oC + szC
        oHE = oHD + bs * bs
        oHB = oHE + bs * bs
        trash = oHB + bs * mB
        self._offs = (szD, szE, szB, szC, oHD, oHE, oHB)

        def rows_of(fam):
            b = blk[fam.vidx]                              # (n, kx)
            has_t = b >= 0
            any_t = has_t.any(1)
            bmax = np.where(any_t, np.where(has_t, b, -1).max(1), -1)
            bmin = np.where(any_t, np.where(has_t, b, nb + 9).min(1), -1)
            # band invariant: a row's T variables span <= 2 adjacent blocks
            if np.any((bmax >= 0) & (bmax - bmin > 1)):
                raise _NotBandShardable
            dev = np.where(bmin >= 0, bmin // nb_loc, np.arange(fam.n) % nd)
            return np.nonzero(dev == rank)[0]

        self._al_tabs = _family_tables(model, rows_of, self.device)
        tgts = []
        for fam, rows, _, _ in self._al_tabs:
            va = fam.vidx[rows]                            # (R, kx)
            ba, oa, pa = blk[va], off[va], bpos[va]
            # la in 0..nb_loc-1 for own blocks; la == nb_loc for the
            # one-past-the-end (halo) block of a boundary-stencil row
            la = ba - rank * nb_loc
            A, Bc = la[:, :, None], la[:, None, :]
            tA, tB = ba[:, :, None] >= 0, ba[:, None, :] >= 0
            oA, oB2 = oa[:, :, None], oa[:, None, :]
            pA, pB = pa[:, :, None], pa[:, None, :]
            tgt = np.full(A.shape[:1] + (fam.kx, fam.kx), trash, np.int64)
            own, halo = A <= nb_loc - 1, A == nb_loc
            # D: same block, local / one past the end
            tgt = np.where(tA & tB & (A == Bc) & own, (A * bs + oA) * bs + oB2,
                           tgt)
            tgt = np.where(tA & tB & (A == Bc) & halo, oHD + oA * bs + oB2,
                           tgt)
            # E: row block = column block + 1 (the lower triangle), stored
            # at the row's local block / in the halo
            tgt = np.where(tA & tB & (A == Bc + 1) & own,
                           oE + (A * bs + oA) * bs + oB2, tgt)
            tgt = np.where(tA & tB & (A == Bc + 1) & halo,
                           oHE + oA * bs + oB2, tgt)
            if mB:
                # B: T row x border column; C: border x border
                tgt = np.where(tA & ~tB & own, oB_ + (A * bs + oA) * mB + pB,
                               tgt)
                tgt = np.where(tA & ~tB & halo, oHB + oA * mB + pB, tgt)
                tgt = np.where(~tA & ~tB, oC + pA * mB + pB, tgt)
            tgts.append(tgt.reshape(-1))
        tgt = np.concatenate(tgts) if tgts else np.zeros(0, np.int64)
        keep = np.nonzero(tgt != trash)[0]
        self._asm_plan = SegmentSum(tgt[keep], trash, self.device, sel=keep,
                                    nnz_total=len(tgt))

        # diagonal additions: this rank's T variables -> its D diagonal
        self._dev_of_t = (t_slots // bs) // nb_loc
        sel = np.nonzero(self._dev_of_t == rank)[0]
        lb = t_slots[sel] // bs - rank * nb_loc
        o_ = t_slots[sel] % bs
        self._dg_src = torch.as_tensor(t_ids[sel], device=self.device)
        self._dg_dst = torch.as_tensor((lb * bs + o_) * bs + o_,
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
        szD, szE, szB, szC, oHD, oHE, oHB = self._offs
        buf, diag_extra = self._local_buffer(x, theta, lam, sigma, d,
                                             diag_extra)
        # the boundary stencils' spill moves one rank to the right (the
        # last rank's halo is exact zeros, and rank 0 adds them)
        halo = self.mesh.ppermute_right(buf[oHD:])
        D = buf[:szD].reshape(nb_loc, bs, bs)
        D[0] += halo[:bs * bs].reshape(bs, bs)
        E = buf[szD:szD + szE].reshape(nb_loc, bs, bs)
        E[0] += halo[bs * bs:2 * bs * bs].reshape(bs, bs)
        B = buf[szD + szE:szD + szE + szB].reshape(nb_loc * bs, mB)
        B[:bs] += halo[2 * bs * bs:].reshape(bs, mB)
        C = self._border_corner(
            buf[szD + szE + szB:oHD].reshape(mB, mB), diag_extra)
        return D, E, B.reshape(nb_loc, bs, mB), C

    # ------------------------------------------------------------------
    # distributed BCR (the arithmetic of block_tridiag._bcr_factor/_solve;
    # per level the segment-edge dependence travels as a halo)
    # ------------------------------------------------------------------
    def _dist_bcr_factor(self, D, E):
        """D, E local (nb_loc, bs, bs); E[k] couples local block k to its
        predecessor (E[0]: across the segment edge, zero on rank 0).
        Returns (levels, tail_levels, tail_root_linv, ok) with ``ok`` this
        rank's own."""
        mesh = self.mesh
        levels = []
        ok = torch.ones((), dtype=torch.bool, device=D.device)
        while D.shape[0] > 1:
            mo = D.shape[0] // 2
            L, Linv, okl = _chol_linv(D[1::2])
            ok = ok & okl
            # E_even[i] couples eliminated block 2i+1 to its LEFT survivor
            # (local E[1::2]); E_odd[i] to its RIGHT survivor 2i+2 (local
            # E[2::2], the last one the right neighbour's E[0]: zero past
            # the global end, since rank 0's E[0] is zero)
            E_next0 = mesh.ppermute_left(E[0])
            E_odd = torch.cat([E[2::2], E_next0[None]])
            E_even = E[1::2]
            levels.append((Linv, E_odd, E_even))
            W1 = _lsolve(L, E_odd.transpose(-1, -2))
            W2 = _lsolve(L, E_even)
            D_new = D[0::2].clone()
            # right-survivor updates -W1^T W1 and the new couplings between
            # survivors -W1^T W2; the last of each crosses the segment edge
            # (one shift right; the last rank sends zeros)
            Lc = torch.matmul(W1.transpose(-1, -2), W1)
            En = -torch.matmul(W1.transpose(-1, -2), W2)
            edge = mesh.ppermute_right(torch.stack([Lc[mo - 1], En[mo - 1]]))
            D_new[1:] -= Lc[:mo - 1]
            D_new[0] -= edge[0]
            # left-survivor updates: -W2^T W2 (all local)
            D_new -= torch.matmul(W2.transpose(-1, -2), W2)
            E = torch.cat([edge[1][None], En[:mo - 1]])
            D = D_new
        # the chain of one block per rank, couplings E[0]
        tail = mesh.all_gather(torch.stack([D[0], E[0]]))   # (nd, 2, bs, bs)
        tail_levels, tail_root, okr = _bcr_factor(
            tail[:, 0].contiguous(), tail[1:, 1].contiguous())
        return levels, tail_levels, tail_root, ok & okr

    def _dist_bcr_solve(self, levels, tail_levels, tail_root, b):
        """Solve T x = b; b local (nb_loc, bs) or (nb_loc, bs, r)."""
        mesh = self.mesh
        vec = b.ndim == 2
        if vec:
            b = b[..., None]
        us = []
        for Linv, E_odd, E_even in levels:
            mo = b.shape[0] // 2
            u = _apply_inv(Linv, b[1::2])
            us.append(u)
            b_new = b[0::2].clone()
            lc = torch.matmul(E_odd, u)
            edge = mesh.ppermute_right(lc[mo - 1])
            b_new[1:] -= lc[:mo - 1]
            b_new[0] -= edge
            b = b_new - torch.matmul(E_even.transpose(-1, -2), u)
        bg = mesh.all_gather(b[0])                          # (nd, bs, r)
        x = _bcr_solve(tail_levels, tail_root, bg)[mesh.rank][None]
        for (Linv, E_odd, E_even), u in zip(reversed(levels), reversed(us)):
            mo = u.shape[0]
            # right-survivor values: x[i+1], the last the right
            # neighbour's x[0]
            x_right = torch.cat([x[1:], mesh.ppermute_left(x[0])[None]])
            t1 = torch.matmul(E_even, x[:mo])
            t2 = torch.matmul(E_odd.transpose(-1, -2), x_right)
            x_odd = u - _apply_inv(Linv, t1 + t2)
            xn = x.new_empty((2 * mo,) + x.shape[1:])
            xn[0::2] = x
            xn[1::2] = x_odd
            x = xn
        return x[..., 0] if vec else x

    # ------------------------------------------------------------------
    def factor(self, K):
        if not self.aligned:
            return super().factor(K)
        D, E, B, C = K
        mB = self.mB
        # Jacobi equilibration, consistent across the segment edge: E[0]'s
        # column scale is the LEFT neighbour's last block scale
        dg = torch.abs(torch.diagonal(D, dim1=-2, dim2=-1))
        sT = 1.0 / torch.sqrt(torch.clamp(dg, min=1e-30))     # (nb_loc, bs)
        s_left = self.mesh.ppermute_right(sT[-1])
        D = D * sT[:, :, None] * sT[:, None, :]
        sE_col = torch.cat([s_left[None], sT[:-1]])
        E = E * sT[:, :, None] * sE_col[:, None, :]
        if mB:
            sB = 1.0 / torch.sqrt(torch.clamp(torch.abs(torch.diag(C)),
                                              min=1e-30))
            B = B * sT[:, :, None] * sB[None, None, :]
            C = C * sB[:, None] * sB[None, :]
        else:
            sB = D.new_zeros(0)
        fdt = self.factor_dtype
        if fdt is not None and fdt != D.dtype:
            D, E, B, C = D.to(fdt), E.to(fdt), B.to(fdt), C.to(fdt)
        levels, tails, troot, ok = self._dist_bcr_factor(D, E)
        if mB:
            Z = self._dist_bcr_solve(levels, tails, troot, B)
            BZ = torch.einsum("kij,kir->jr", B, Z)
        else:
            Z = BZ = D.new_zeros((self.nb_loc, self.bs, 0))
        Ls, ok = self._border_factor(C, BZ, ok)
        return (levels, tails, troot, Z, Ls, sT, sB), ok

    # ------------------------------------------------------------------
    def solve_tl(self, fac, r):
        """Solve in T-layout: the BCR halos (O(bs) per level), the
        O(size*bs) tail gather and one O(mB) border psum -- nothing O(n)."""
        levels, tails, troot, Z, Ls, sT, sB = fac
        rT2, rB = r
        dt = rT2.dtype
        rT = (rT2.reshape(self.nb_loc, self.bs) * sT).to(Z.dtype)
        u = self._dist_bcr_solve(levels, tails, troot, rT)
        x1, xB = self._border_solve(Z, Ls, sB, u, rT, rB, dt)
        return (x1.to(dt) * sT).reshape(-1), xB

    # ------------------------------------------------------------------
    def matvec_tl(self, K, v):
        """K @ v in T-layout: two O(bs) halo shifts + one O(mB) psum."""
        D, E, B, C = K
        vT2, vB = v
        nb_loc = self.nb_loc
        vT = vT2.reshape(nb_loc, self.bs).to(D.dtype)
        # the left neighbour's last-block values
        v_left = self.mesh.ppermute_right(vT[-1])
        oT = torch.matmul(D, vT[..., None])[..., 0]
        vprev = torch.cat([v_left[None], vT[:-1]])
        oT = oT + torch.matmul(E, vprev[..., None])[..., 0]
        # E^T part: out[k-1] += E[k]^T v[k]; block 0's goes to the LEFT
        # neighbour's last block
        up = torch.matmul(E.transpose(-1, -2), vT[..., None])[..., 0]
        oT[:nb_loc - 1] += up[1:]
        oT[nb_loc - 1] += self.mesh.ppermute_left(up[0])
        oT, oB = self._border_matvec(B, C, vT, vB, oT, vT2.dtype)
        return oT.reshape(-1).to(vT2.dtype), oB
