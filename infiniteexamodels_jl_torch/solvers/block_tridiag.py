"""Structured condensed-KKT backends: block-tridiagonal / block-diagonal
plus dense arrowhead.

Transcribed problems have two dominant KKT structures (SURVEY.md §5, §7):
time-stencil coupling -> block-banded; scenario coupling through first-stage
variables -> block-diagonal + arrowhead border.  Both are instances of

    K = [ T    B ]      T: nb blocks of size bs (tridiagonal or diagonal)
        [ B^T  C ]      B: (nT, m) border, C: (m, m) dense corner

The structure is recovered once at build time, by torch on the model's
device (the graph ordering alone by scipy on the host), and factorized with
dense per-block operations on the card:

- high-degree variables form the border (first-stage coupling),
- the remaining T-subgraph is split into connected components: many small
  components (scenarios) -> component-aligned blocks, batched inverse-SPD
  per block; one big component (time) -> reverse-Cuthill-McKee or
  support-interleaved band, **block cyclic reduction** (BCR: log-depth,
  batched matmuls),
- the border is eliminated with a dense Schur complement
  S = C - B^T T^{-1} B, with Z = T^{-1} B precomputed at factor time.

Every eliminated block goes through K1 (:func:`.chol_linv.chol_linv`, the
hand-written Hopper kernel): Cholesky plus the explicit inverse factor, so
the solve sweeps are batched matmuls.  Assembly is a deterministic gather +
segment-sum of the per-family COO value stream into the blocks.

On a CUDA backend without a mesh, :meth:`BlockTridiagKKT.solve` is a CUDA
graph (``utils/cuda_graphs.py``, as the AD sweeps are): a solve is some
hundreds of small kernels (BCR's ~20 a level down and up), launched one at
a time by the host, for about a millisecond of device work.  A graph reads
the tensors it was captured on, so there :meth:`~BlockTridiagKKT.factor`
writes each factorization into the same buffers (:class:`_Placement`, one
per factor dtype) and a solve with an older factorization than the last
raises.  The graph launches the eager solve's kernels in the same order,
so it returns the eager result bit for bit.  The sharded subclasses, whose
solves run collectives, and everything on the CPU stay eager.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from ..ops.segsum import SegmentSum
from ..utils.cuda_graphs import GraphCache
from ..utils.timers import span
from . import bcr_level
from .chol_linv import chol_linv
from .kkt import CondensedKKT, DenseKKT

# the solve's graph counters: captures, replays and eager solves
KKT_COUNTERS = ("kkt.solve_graph_captures", "kkt.solve_graph_replays",
                "kkt.eager_solves")


# ----------------------------------------------------------------------
# batched SPD helpers / block cyclic reduction
# ----------------------------------------------------------------------
def _chol_linv(D):
    """Batched Cholesky D = L L^T plus the explicit triangular inverse
    L^{-1} (K1, every dtype).  Applying D^{-1} is then two batched matmuls:
    D^{-1} b = L^{-T} (L^{-1} b)."""
    return chol_linv(D.contiguous())


def _apply_inv(Linv, b, out=None):
    """D^{-1} b = L^{-T} (L^{-1} b) from the stored triangular inverse."""
    return torch.matmul(Linv.transpose(-1, -2), torch.matmul(Linv, b),
                        out=out)


class _Placement:
    """Where the graphed path leaves the factorizations of one factor
    dtype: buffers allocated at the first and rewritten by each later one,
    so the solve's graphs read the newest.  ``generation`` counts the
    factorizations begun in them."""

    def __init__(self):
        self.bufs = {}
        self.generation = 0


def _out(place, name, shape, like):
    """The buffer ``name`` of ``place``, for an op to write its result
    into; None (new memory) on the eager path, where ``place`` is None."""
    if place is None:
        return None
    buf = place.bufs.get(name)
    if buf is None:
        buf = place.bufs[name] = like.new_empty(shape)
    return buf


def _keep(place, name, t):
    """``t`` copied into the buffer ``name`` of ``place``, for a result
    whose op cannot write in place; the first factorization's ``t`` becomes
    the buffer, so it keeps the op's own layout (a column-major Cholesky
    factor stays one, and the solve's kernels read it as eagerly).  ``t``
    itself on the eager path."""
    if place is None:
        return t
    buf = place.bufs.setdefault(name, t)
    return buf if buf is t else buf.copy_(t)


class _Factorization(tuple):
    """``(tfac, Z, Ls, sT, sB)``.  On the graphed path it lies in the
    buffers of ``placement``, as the placement's ``generation``-th
    factorization left them; on the eager path in memory of its own, with
    ``placement`` None."""

    def __new__(cls, parts, placement=None):
        fac = super().__new__(cls, parts)
        fac.placement = placement
        fac.generation = (None if placement is None
                          else placement.generation)
        return fac


def _bcr_factor(D, E, place=None):
    """Block-cyclic-reduction factorization of the SPD block-tridiagonal
    matrix with diagonal blocks ``D`` (nb, bs, bs) and sub-diagonal blocks
    ``E`` (nb-1, bs, bs) where ``E[j]`` couples row block j+1 to column
    block j.

    Stability note: the Schur updates of the surviving even blocks are
    computed in *Gram form* -- with W1 = L^{-1} E_odd^T and
    W2 = L^{-1} E_even (batched triangular solves at factor time), the
    updates are ``-W^T W``, which cannot push a block spuriously indefinite
    the way explicit-inverse sandwiches ``E D^{-1} E^T`` can.  The solve
    phase then uses the stored explicit triangular inverses so every sweep
    is pure batched matmuls.

    Each level is one K1 launch and its Schur update,
    :func:`.bcr_level.bcr_level`: K2, two launches, on the card; the plain
    version on the CPU.  It writes the next level's couplings into that
    level's ``Epad`` buffer and its blocks odd ones first, so only level 0
    concatenates and copies.

    Returns ``(levels, root, ok)``: per-level tuples
    ``(Linv, E_odd, E_even)`` plus the root block's ``Linv``.  Depth is
    ceil(log2(nb)); every level is batched, and the root is one more K1
    launch.  ``place`` (a :class:`_Placement`, or None for new memory) says
    where the stored factors go."""
    levels = []
    ok = torch.ones((), dtype=torch.bool, device=D.device)
    shape = D.shape[1:]
    zpad = torch.zeros((1,) + shape, dtype=D.dtype, device=D.device)
    Epad = torch.cat([E, zpad], out=_out(place, ("Epad", 0),
                                         (D.shape[0],) + shape, D))
    # the level's odd blocks (K1's input) and even blocks
    odd, even = D[1::2], D[0::2]
    while odd.shape[0]:
        m_odd, m_even = odd.shape[0], even.shape[0]
        lvl = len(levels)
        L, Linv, okl = _chol_linv(odd)
        Linv = _keep(place, ("Linv", lvl), Linv)
        ok = ok & okl
        levels.append((Linv, Epad[1::2], Epad[0::2][:m_odd]))
        D_next = D.new_empty((m_even,) + shape)
        E_next = None
        if m_even > 1:
            E_next = _out(place, ("Epad", lvl + 1), (m_even,) + shape, D)
            if E_next is None:
                E_next = D.new_empty((m_even,) + shape)
        bcr_level.bcr_level(L, Epad, even, D_next, E_next)
        odd, even = D_next[:m_even // 2], D_next[m_even // 2:]
        Epad = E_next
    _, root_linv, okr = _chol_linv(even)
    return levels, _keep(place, "root_linv", root_linv), ok & okr


def _bcr_solve(levels, root_linv, b):
    """Solve T x = b given the BCR factorization; ``b`` is (nb, bs) or
    (nb, bs, r).  Down-sweep + up-sweep, all batched matmuls."""
    vec = b.ndim == 2
    if vec:
        b = b[..., None]
    us = []
    for Linv, E_odd, E_even in levels:
        m = b.shape[0]
        m_odd, m_even = m // 2, (m + 1) // 2
        u = _apply_inv(Linv, b[1::2])
        us.append(u)
        b_new = b[0::2].clone()
        lc = torch.matmul(E_odd, u)
        b_new[1:] -= lc[:m_even - 1]
        rc = torch.matmul(E_even.transpose(-1, -2), u)
        b_new[:m_odd] -= rc
        b = b_new
    x = _apply_inv(root_linv, b)
    for (Linv, E_odd, E_even), u in zip(reversed(levels), reversed(us)):
        m_odd = u.shape[0]
        m_even = x.shape[0]
        xpad = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        t1 = torch.matmul(E_even, x[:m_odd])
        t2 = torch.matmul(E_odd.transpose(-1, -2), xpad[1:1 + m_odd])
        x_odd = u - _apply_inv(Linv, t1 + t2)
        xn = x.new_empty((m_even + m_odd,) + x.shape[1:])
        xn[0::2] = x
        xn[1::2] = x_odd
        x = xn
    return x[..., 0] if vec else x


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class BlockTridiagKKT(CondensedKKT):
    """Structured condensed-KKT backend.  Build-time analysis happens once;
    per-iteration work is gather + segment-sum assembly + block
    factorization.

    ``factor_dtype=torch.float32`` factors in single precision: the blocks
    are equilibrated in the assembly's dtype, then cast, so BCR, the K1
    launches, the Gram-form triangular solves and the border Schur factor
    all run in f32, and :meth:`solve` hands back the right-hand side's
    dtype.  :meth:`low_precision_view` also lowers the Hessian sweep and the
    block assembly (``assemble_dtype``); elsewhere K stays in the model's
    dtype."""

    assemble_dtype = None
    factorizations = 0      # calls of :meth:`factor` on this instance

    def __init__(self, model, max_block=512, min_blocks=4, max_border=4096,
                 factor_dtype=None, mesh=None, mesh_axis="sp",
                 nb_round=None):
        self.factor_dtype = factor_dtype
        self.model = model
        self.device = model.device
        # the mesh the sharded subclasses split the blocks over; this class
        # itself factors the whole system on every rank (its inputs, the
        # model's gathered KKT values, are the same on every rank).
        # ``mesh_axis`` is accepted for the reference's signature: a mesh
        # here is one process group, with one axis
        self.mesh = mesh if mesh is not None else getattr(model, "mesh",
                                                          None)
        # the graphed path (see the module's note): the solve's graphs and
        # the placements by factor dtype, both shared with the f32 view
        # (:meth:`low_precision_view`), each view keeping to its own dtype's
        self._graphs = GraphCache(self.device, self.mesh, *KKT_COUNTERS)
        self._placements = {}
        self._analyse(model, max_block, min_blocks, max_border, nb_round)

    def _analyse(self, model, max_block, min_blocks, max_border, nb_round):
        """The structure analysis: the border, the block layout (``mode``,
        ``nb``, ``bs``, every T variable's padded ``slot``), the entry
        classification and the device tables.  Torch ops on the model's
        device, over the Hessian's COO pattern uploaded once; only the
        graph ordering (connected components, reverse Cuthill-McKee) runs
        on the host, by scipy, on the T-subgraph's canonical CSR copied
        from the device.  Sets ``usable`` False where the structure does
        not fit; the caller falls back."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import (reverse_cuthill_mckee,
                                          connected_components)

        dev = self.device
        n = model.nvar

        def arange(k):
            return torch.arange(k, device=dev)

        with span("kkt.analysis"):
            rows = torch.as_tensor(model.hess_rows_np, device=dev)
            cols = torch.as_tensor(model.hess_cols_np, device=dev)
            # the pattern without duplicates, row-major, and the degrees
            key = torch.unique(rows * n + cols)
            ur, uc = key // n, key % n
            deg = torch.bincount(ur, minlength=n)
            border_mask = self._border(deg, max_border)
            t_mask = ~border_mask
            t_ids = torch.nonzero(t_mask)[:, 0]
            b_ids = torch.nonzero(border_mask)[:, 0]
            nT, mB = len(t_ids), len(b_ids)
            self.n, self.nT, self.mB = n, nT, mB
            if nT == 0:
                self.usable = False
                return
            # the T-subgraph, numbered by rank in t_ids: its entries are the
            # pattern's T x T entries, still row-major with no duplicates
            tpos = torch.full((n,), -1, dtype=torch.int64, device=dev)
            tpos[t_ids] = arange(nT)
            tt = t_mask[ur] & t_mask[uc]
            sr, sc = tpos[ur[tt]], tpos[uc[tt]]
            indptr = torch.zeros(nT + 1, dtype=torch.int64, device=dev)
            indptr[1:] = torch.cumsum(torch.bincount(sr, minlength=nT), 0)

        with span("kkt.order"):
            sub = sp.csr_matrix(
                (np.ones(len(sc)), sc.to(torch.int32).cpu().numpy(),
                 indptr.to(torch.int32).cpu().numpy()), shape=(nT, nT))
            ncomp, labels = connected_components(sub, directed=False)
            comp_sizes = np.bincount(labels) if ncomp else np.zeros(0, int)
            scenario = ncomp >= min_blocks and comp_sizes.max() <= max_block
            if not scenario:
                perm = reverse_cuthill_mckee(sub, symmetric_mode=True)

        with span("kkt.analysis"):
            # padded position of every T variable + block size
            slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
            if scenario:
                # scenario mode: one block per component, padded to a
                # common bs
                bs = _round_up(int(comp_sizes.max()), 8)
                nb = int(ncomp)
                # position of each T variable inside its component, in
                # variable order: rank within a stable sort by component
                labels = torch.as_tensor(labels, device=dev).long()
                sizes = torch.as_tensor(comp_sizes, device=dev)
                first = torch.cumsum(sizes, 0) - sizes
                by_comp = torch.sort(labels, stable=True).indices
                offsets = torch.empty(nT, dtype=torch.int64, device=dev)
                offsets[by_comp] = arange(nT) - first[labels[by_comp]]
                slot[t_ids] = labels * bs + offsets
                self.mode = "block_diag"
            else:
                # time mode: band ordering.  Two candidates, smaller
                # bandwidth wins -- factor cost scales with bs^2 * nT:
                # (a) reverse Cuthill-McKee on the T-subgraph (general), and
                # (b) support-interleaved order (variables sorted by
                #     relative position within their tensor, i.e.
                #     time-major across all state/control/derivative
                #     tensors) -- on transcribed OCPs this groups each
                #     support's variables together and often beats the RCM
                #     heuristic by 2-3x.
                def band_of(order):
                    pos = torch.empty(nT, dtype=torch.int64, device=dev)
                    pos[order] = arange(nT)
                    d = (pos[sr] - pos[sc]).abs()
                    return pos, int(d.max()) if len(d) else 0

                pos_rcm, bw_rcm = band_of(
                    torch.as_tensor(np.ascontiguousarray(perm),
                                    device=dev).long())
                pos_int = bw_int = None
                variables = getattr(getattr(model, "core", None),
                                    "variables", None)
                if variables:
                    frac = torch.zeros(n, dtype=torch.float64, device=dev)
                    vid = torch.zeros(n, dtype=torch.int64, device=dev)
                    for v in variables:
                        sl = slice(v.offset, v.offset + v.length)
                        frac[sl] = (torch.arange(v.length, dtype=torch.float64,
                                                 device=dev)
                                    / max(v.length, 1))
                        vid[sl] = v.vid
                    # sorted by frac, then vid, then variable (a lexsort)
                    key = torch.sort(vid[t_ids], stable=True).indices
                    key = key[torch.sort(frac[t_ids][key],
                                         stable=True).indices]
                    pos_int, bw_int = band_of(key)
                # prefer RCM unless the interleave wins decisively: factor
                # work scales with (bw+1)^2 so a 2/3 bandwidth cut is ~2x,
                # but marginal wins are not worth trading away RCM's track
                # record on numerically delicate (degenerate-endgame)
                # problems
                if bw_int is not None and bw_int < 0.66 * bw_rcm:
                    pos, bw = pos_int, bw_int
                else:
                    pos, bw = pos_rcm, bw_rcm
                bs = _round_up(max(bw, 1) + 1, 8)
                nb = max((nT + bs - 1) // bs, 1)
                if nb_round is not None:
                    # round the block count up for mesh segmentation (band
                    # partitioning); extra blocks are pure identity padding
                    nb = max(int(nb_round(nb)), nb)
                slot[t_ids] = pos
                self.mode = "band"

            self.bs, self.nb = bs, nb
            self.usable = bs <= max_block and nb >= min_blocks
            if not self.usable:
                return
            nTpad = nb * bs
            self.nTpad = nTpad

            # -- entry classification (static) ---------------------------
            tr, bc = t_mask[rows], border_mask[cols]
            tt = tr & ~bc
            pr, pc = slot[rows], slot[cols]
            blk_r = torch.where(pr >= 0, pr // bs, -9)
            blk_c = torch.where(pc >= 0, pc // bs, -9)
            if bool((tt & ((blk_r - blk_c).abs() > 1)).any()):
                # structure assumption violated; caller falls back
                self.usable = False
                return
            selD = torch.nonzero(tt & (blk_r == blk_c))[:, 0]
            selL = torch.nonzero(tt & (blk_r == blk_c + 1))[:, 0]
            selB = torch.nonzero(tr & bc)[:, 0]
            selC = torch.nonzero(~tr & bc)[:, 0]
            self.block_diag = (self.mode == "block_diag") or len(selL) == 0
            bpos = torch.full((n,), -1, dtype=torch.int64, device=dev)
            bpos[b_ids] = arange(mB)

        # gather + segment-sum plans of the COO value stream, one per
        # target block array
        nnz_total = len(rows)
        with span("kkt.plans"):
            def plan(sel, dest, size):
                return SegmentSum(dest, size, dev, sel=sel,
                                  nnz_total=nnz_total)

            def blk_off(sel, blk):
                return (blk[sel] * bs * bs + (pr[sel] % bs) * bs
                        + pc[sel] % bs)

            self.D_plan = plan(selD, blk_off(selD, blk_r), nb * bs * bs)
            self.L_plan = plan(selL, blk_off(selL, blk_c),
                               max(nb - 1, 1) * bs * bs)
            self.B_plan = plan(selB, pr[selB] * mB + bpos[cols[selB]],
                               nTpad * mB)
            self.C_plan = plan(selC, bpos[rows[selC]] * mB + bpos[cols[selC]],
                               mB * mB)

        with span("kkt.analysis"):
            # scatter targets for diagonal additions + rhs permutation
            self._slot_np = slot.cpu().numpy()
            self.t_ids_np = t_ids.cpu().numpy()
            self.b_ids_np = b_ids.cpu().numpy()
            self.b_ids = b_ids
            tslot = slot[t_ids]
            # diagonal additions: sorted + unique flat destinations in D
            dorder = torch.sort(tslot, stable=True).indices
            self.diag_take = t_ids[dorder]
            self.diag_dest = ((tslot[dorder] // bs) * bs * bs
                              + (tslot[dorder] % bs) * (bs + 1))
            # rhs/solution permutations as pure GATHERS (no scatter at
            # all): slot_src[s] = source variable of padded slot s
            # (self-index for pads, masked to 0), out_perm[i] = position of
            # variable i in concat([x_T.flat (nTpad), x_B (mB)])
            occupied = torch.zeros(nTpad, dtype=torch.bool, device=dev)
            occupied[tslot] = True
            slot_src = torch.zeros(nTpad, dtype=torch.int64, device=dev)
            slot_src[tslot] = t_ids
            self.slot_src = slot_src
            self.slot_mask = occupied.reshape(nb, bs).to(model.dtype)
            out_perm = torch.zeros(n, dtype=torch.int64, device=dev)
            out_perm[t_ids] = tslot
            out_perm[b_ids] = nTpad + arange(mB)
            self.out_perm = out_perm
            # unit diagonal on padding slots so Cholesky stays well-posed
            self.pad_eye = torch.diag_embed(
                (~occupied).reshape(nb, bs).to(model.dtype))

    @staticmethod
    def _border(deg, max_border):
        """The border: variables of unusually high degree (first-stage
        coupling), above ``max(8 * median, 32)``; past ``max_border`` of
        them, the ``max_border`` of highest degree, cut where numpy's
        ``argsort`` cuts (on the host: its order among equal degrees is
        its own)."""
        n = len(deg)
        ds = torch.sort(deg).values
        k = n // 2
        # int(np.median(deg)): the mean of the middle two, truncated
        med = int(ds[k]) if n % 2 else (int(ds[k - 1]) + int(ds[k])) // 2
        border_mask = deg > max(8 * max(med, 1), 32)
        if int(border_mask.sum()) > max_border:
            order = np.argsort(deg.cpu().numpy())[::-1]
            mask = np.zeros(n, bool)
            mask[order[:max_border]] = True
            border_mask = torch.as_tensor(mask, device=deg.device)
        return border_mask

    def low_precision_view(self):
        """This backend assembling and factoring in f32: a shallow copy, so
        it shares the structure analysis, the device tables, the placements
        and the solve's graphs."""
        view = copy.copy(self)
        view.factor_dtype = view.assemble_dtype = torch.float32
        return view

    # ------------------------------------------------------------------
    def assemble(self, x, theta, lam, sigma, d, diag_extra):
        m = self.model
        vals = m.kkt_vals(x, theta, lam, sigma, d, dtype=self.assemble_dtype)
        dt = vals.dtype
        nb, bs, mB = self.nb, self.bs, self.mB

        if nb > 1 and not self.block_diag:
            L = self.L_plan(vals).reshape(nb - 1, bs, bs)
        else:
            L = torch.zeros((max(nb - 1, 1), bs, bs), dtype=dt,
                            device=vals.device)
        Dflat = self.D_plan(vals)
        B = self.B_plan(vals).reshape(self.nTpad, mB)
        C = self.C_plan(vals).reshape(mB, mB)
        # unique destinations: a plain indexed add, deterministic
        Dflat[self.diag_dest] += diag_extra[self.diag_take].to(dt)
        D = Dflat.reshape(nb, bs, bs) + self.pad_eye.to(dt)
        if mB:
            C = C + torch.diag(diag_extra[self.b_ids].to(dt))
        return (D, L, B.reshape(nb, bs, mB), C)

    # ------------------------------------------------------------------
    def matvec(self, K, v):
        """K @ v from the block representation (used by the IPM's iterative
        refinement of the condensed solve)."""
        D, L, B, C = K
        nb, bs, mB = self.nb, self.bs, self.mB
        out_dt = v.dtype
        dt = D.dtype
        v = v.to(dt)
        # padded-slot layout via pure gather + pad mask (no scatter)
        vT = v[self.slot_src].reshape(nb, bs) * self.slot_mask.to(dt)
        out_T = torch.matmul(D, vT[..., None])[..., 0]
        if nb > 1 and not self.block_diag:
            low = torch.matmul(L, vT[:-1, :, None])[..., 0]
            up = torch.matmul(L.transpose(-1, -2), vT[1:, :, None])[..., 0]
            out_T = out_T.clone()
            out_T[1:] += low
            out_T[:-1] += up
        if mB:
            vB = v[self.b_ids]
            out_T = out_T + torch.einsum("bij,j->bi", B, vB)
            out_B = torch.einsum("bij,bi->j", B, vT) + C @ vB
        else:
            out_B = torch.zeros(0, dtype=dt, device=v.device)
        out = torch.cat([out_T.reshape(-1), out_B])[self.out_perm]
        return out.to(out_dt)

    def k1_launches_per_factorization(self):
        """K1 launches of one :meth:`factor`: one for the block-diagonal
        branch; one per BCR level plus the root in band mode."""
        if self.block_diag:
            return 1
        m, launches = self.nb, 1
        while m > 1:
            m, launches = (m + 1) // 2, launches + 1
        return launches

    # ------------------------------------------------------------------
    def factor(self, K):
        """Factor ``K = (D, L, B, C)``; returns ``(fac, ok)``.  Jacobi
        equilibration, then the blocks: one K1 launch over all ``nb`` in
        the block-diagonal branch, one a level in BCR.  With a border of
        ``mB`` variables, its elimination besides: ``Z = T^{-1} B`` (``mB``
        right-hand sides through the blocks' inverses), the Schur
        complement ``C - B^T Z`` (one einsum reduced over the ``nb``
        blocks) and its ``mB x mB`` Cholesky (6x6 for opf).  The border has
        no span of its own: in the IPM its time falls under
        ``kkt.factor``.

        On the graphed path the factorization is written into the buffers
        of its factor dtype's :class:`_Placement` (the level's ``Epad`` in
        place, the rest copied there), which makes every earlier
        factorization of that dtype stale."""
        self.factorizations += 1
        D, L, B, C = K
        nb, bs, mB = self.nb, self.bs, self.mB

        # Jacobi (symmetric diagonal) equilibration -- ALWAYS.  The
        # condensed KKT carries ~1/delta_c (1e8+) diagonal entries from the
        # lifted equalities; the explicit-inverse BCR (unlike backward-
        # stable triangular solves) needs the per-block conditioning tamed
        # or the IPM's Newton steps lose too many digits for the iterative
        # refinement to recover.
        dg = torch.abs(torch.diagonal(D, dim1=-2, dim2=-1))
        sT = 1.0 / torch.sqrt(torch.clamp(dg, min=1e-30))      # (nb, bs)
        D = D * sT[:, :, None] * sT[:, None, :]
        if nb > 1 and not self.block_diag:
            L = L * sT[1:, :, None] * sT[:-1, None, :]
        if mB:
            sB = 1.0 / torch.sqrt(torch.clamp(torch.abs(torch.diag(C)),
                                              min=1e-30))
            B = B * sT[:, :, None] * sB[None, None, :]
            C = C * sB[:, None] * sB[None, :]
        else:
            sB = D.new_zeros(0)
        fdt = self.factor_dtype
        if fdt is not None and fdt != D.dtype:
            D, L, B, C = D.to(fdt), L.to(fdt), B.to(fdt), C.to(fdt)
        place = None
        if self._graphs.on:
            place = self._placements.setdefault(D.dtype, _Placement())
            place.generation += 1

        if self.block_diag:
            # batched per-block Cholesky + explicit triangular inverses
            _, Linv, ok = _chol_linv(D)
            Linv = _keep(place, "Linv", Linv)
            tfac = (Linv,)
            Z = _apply_inv(Linv, B, out=_out(place, "Z", B.shape, B)) if mB \
                else D.new_zeros((nb, bs, 0))
        else:
            levels, root_inv, ok = _bcr_factor(D, L[:nb - 1], place)
            tfac = (levels, root_inv)
            Z = _keep(place, "Z", _bcr_solve(levels, root_inv, B)) if mB \
                else D.new_zeros((nb, bs, 0))

        if mB:
            # S = C - B^T T^{-1} B; border solves reduce to matmuls with Z
            Ls = self._schur_cholesky(C - torch.einsum("bij,bik->jk", B, Z))
            ok = ok & torch.isfinite(Ls).all()
        else:
            Ls = D.new_zeros((0, 0))
        fac = (tfac, Z, _keep(place, "Ls", Ls), _keep(place, "sT", sT),
               _keep(place, "sB", sB))
        return _Factorization(fac, place), ok

    @staticmethod
    def _schur_cholesky(S):
        """Cholesky factor of the border's Schur complement ``S`` (mB, mB);
        NaN where ``S`` is not SPD."""
        Ls, info = torch.linalg.cholesky_ex(S)
        return torch.where(info != 0, torch.nan, Ls)

    # ------------------------------------------------------------------
    def _t_solve(self, tfac, r):
        """Solve T u = r (r: (nb, bs) or (nb, bs, k)) -- batched matmuls."""
        vec = r.ndim == 2
        if self.block_diag:
            (Linv,) = tfac
            out = _apply_inv(Linv, r[..., None] if vec else r)
            return out[..., 0] if vec else out
        levels, root_linv = tfac
        return _bcr_solve(levels, root_linv, r)

    def solve(self, fac, rhs):
        """``K^{-1} rhs`` in ``rhs``'s dtype: scaled, cast to the factor's
        dtype, solved there, cast back and unscaled.  With a border, two
        einsum reductions over the blocks (``Z^T r_T``, ``Z x_B``) and two
        triangular solves with the ``mB x mB`` Schur factor besides; in the
        IPM their time falls under ``kkt.solve``.

        A factorization of the graphed path is solved by the graph of its
        placement and of ``rhs``'s shape and dtype, captured at the first
        such solve: ``rhs`` is copied in, the graph replayed and its output
        cloned, so a kept result survives the next replay.  On the card the
        call then returns once the replay is launched, and its device time
        shows at the caller's next wait."""
        place = fac.placement
        if place is not None and fac.generation != place.generation:
            raise RuntimeError(
                f"stale factorization: generation {fac.generation} solved "
                f"after factorization {place.generation} of its dtype "
                f"overwrote its buffers")
        return self._graphs(place, functools.partial(self._eager_solve, fac),
                            rhs)

    def _eager_solve(self, fac, rhs):
        """:meth:`solve`'s kernels, launched one at a time."""
        tfac, Z, Ls, sT, sB = fac
        nb, bs, mB = self.nb, self.bs, self.mB
        dt, fdt = rhs.dtype, Z.dtype
        rT = rhs[self.slot_src].reshape(nb, bs) * self.slot_mask.to(dt)
        rT = (rT * sT).to(fdt)
        u = self._t_solve(tfac, rT)                   # (nb, bs)
        if mB:
            rB = (rhs[self.b_ids] * sB).to(fdt)
            # x_B = S^{-1} (r_B - Z^T r_T);  x_T = u - Z x_B
            rhs2 = rB - torch.einsum("bij,bi->j", Z, rT)
            z2 = torch.linalg.solve_triangular(Ls, rhs2[:, None], upper=False)
            x2 = torch.linalg.solve_triangular(Ls.T, z2, upper=True)[:, 0]
            x1 = u - torch.einsum("bij,j->bi", Z, x2)
            x2 = x2.to(dt) * sB
        else:
            x1 = u
            x2 = rhs.new_zeros(0)
        x1 = x1.to(dt) * sT
        return torch.cat([x1.reshape(-1), x2])[self.out_perm]


def make_structured_kkt(model, fallback=True, **kwargs):
    """Detect block structure; fall back to the dense backend when the
    problem is too small or has no usable block layout.  With a mesh of
    more than one rank (``mesh=`` or the model's), a scenario problem gets
    the aligned :class:`~.scenario_shard.ShardedScenarioKKT`, a band
    problem it cannot align the :class:`~.band_shard.ShardedBandKKT`, and
    anything neither aligns their single-device fallback (every rank
    factors the whole system).  Only the structure analysis is guarded: assembly, factoring and the kernel are never reached here,
    and their failures propagate to the caller."""
    mesh = kwargs.get("mesh") or getattr(model, "mesh", None)
    try:
        if mesh is not None and mesh.size > 1:
            from .scenario_shard import ShardedScenarioKKT

            kkt = ShardedScenarioKKT(model, **kwargs)
            if kkt.usable and not kkt.aligned and kkt.mode == "band":
                # time-structured problem on a mesh: segment the band
                from .band_shard import ShardedBandKKT

                band = ShardedBandKKT(model, **kwargs)
                if band.usable:
                    kkt = band
        else:
            kkt = BlockTridiagKKT(model, **kwargs)
    except Exception:
        if not fallback:
            raise
        kkt = None
    if kkt is not None and kkt.usable:
        return kkt
    if fallback:
        # no low-precision view: the low-precision step sets run in f64 here
        return DenseKKT(model)
    raise NotImplementedError(
        "no usable block structure and fallback disabled")
