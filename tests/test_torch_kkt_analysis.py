"""The band/scenario KKT's structure analysis and the segment-sum plans,
computed by torch on the model's device, against the numpy path they
replace, kept here as plain oracles (:func:`numpy_gather_plan`,
:func:`numpy_analysis`): every table equal, element by element.

- the analysis on quad-12 and quad-200 (band), hovercraft-41 (two
  components: band with the default ``min_blocks``, blocks with 2),
  farmer-64 and design_3node-100 (scenario blocks with a border),
  pandemic-56x10 (band with a border of 66), opf-10 and opf-100 (scenario
  blocks with a border of 6), and the border cut at ``max_border``, a
  rounded block count (the sharded band's ``nb_round``);
- the fallbacks to :class:`DenseKKT`: too few blocks, a band too wide,
  an entry that crosses blocks;
- :func:`gather_plan` on skewed multiplicities, a selection and an empty
  stream.

The file imports neither JAX nor the JAX package, so the card test
(``test_torch_kkt_analysis_cuda.py``) takes its oracle from here.
"""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.ops.segsum import SegmentSum, gather_plan
from infiniteexamodels_jl_torch.solvers import DenseKKT
from infiniteexamodels_jl_torch.solvers import block_tridiag as bt
from infiniteexamodels_jl_torch.transcribe import transcribe


# ----------------------------------------------------------------------
# the oracles: the numpy analysis as the port computed it before
# ----------------------------------------------------------------------
def numpy_gather_plan(dest, sel=None, nnz_total=None):
    """Buckets ``[(tab, u), ...]`` (numpy) for ``out[dest[k]] +=
    vals[sel[k]]``."""
    dest = np.asarray(dest, dtype=np.int64).reshape(-1)
    sel = (np.arange(len(dest), dtype=np.int64) if sel is None
           else np.asarray(sel, dtype=np.int64).reshape(-1))
    nnz_total = len(dest) if nnz_total is None else int(nnz_total)
    if len(dest) == 0:
        return []
    order = np.argsort(dest, kind="stable")
    sel_s, dest_s = sel[order], dest[order]
    u, start, counts = np.unique(dest_s, return_index=True,
                                 return_counts=True)
    width = 1 << np.ceil(np.log2(counts)).astype(np.int64)
    buckets = []
    for w in np.unique(width):
        rows = np.nonzero(width == w)[0]
        idx = start[rows, None] + np.arange(w)[None, :]
        valid = np.arange(w)[None, :] < counts[rows, None]
        tab = np.where(valid, sel_s[np.minimum(idx, len(sel_s) - 1)],
                       nnz_total)
        buckets.append((tab.astype(np.int64), u[rows].astype(np.int64)))
    return buckets


def numpy_analysis(model, max_block=512, min_blocks=4, max_border=4096,
                   nb_round=None):
    """The tables of ``BlockTridiagKKT(model, ...)`` as its numpy analysis
    made them: a dict, with ``usable`` False (and what was known by then)
    where the structure does not fit.  The block size is rounded by the
    module's ``_round_up``, so a test that replaces it changes both."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import (reverse_cuthill_mckee,
                                      connected_components)

    out = {}
    n = model.nvar
    rows, cols = model.hess_rows_np, model.hess_cols_np
    adj = sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n, n)).tocsr()
    adj.sum_duplicates()
    deg = np.diff(adj.indptr)
    med = max(int(np.median(deg)), 1)
    thresh = max(8 * med, 32)
    border_mask = deg > thresh
    if border_mask.sum() > max_border:
        order = np.argsort(deg)[::-1]
        border_mask = np.zeros(n, bool)
        border_mask[order[:max_border]] = True
    t_mask = ~border_mask
    t_ids = np.nonzero(t_mask)[0]
    b_ids = np.nonzero(border_mask)[0]
    nT, mB = len(t_ids), len(b_ids)
    out.update(n=n, nT=nT, mB=mB, usable=False)
    if nT == 0:
        return out
    sub = adj[t_ids][:, t_ids]
    ncomp, labels = connected_components(sub, directed=False)
    comp_sizes = np.bincount(labels) if ncomp else np.zeros(0, int)
    slot = np.full(n, -1, dtype=np.int64)
    if ncomp >= min_blocks and comp_sizes.max() <= max_block:
        bs = bt._round_up(int(comp_sizes.max()), 8)
        nb = int(ncomp)
        by_comp = np.argsort(labels, kind="stable")
        first = np.concatenate([[0], np.cumsum(comp_sizes)[:-1]])
        offsets = np.empty(nT, dtype=np.int64)
        offsets[by_comp] = np.arange(nT) - first[labels[by_comp]]
        slot[t_ids] = labels * bs + offsets
        mode = "block_diag"
    else:
        tt = t_mask[rows] & t_mask[cols]

        def band_of(order):
            pos = np.full(n, -1, dtype=np.int64)
            pos[order] = np.arange(len(order))
            return pos, int(np.max(np.abs(pos[rows[tt]] - pos[cols[tt]]),
                                   initial=0))

        perm = reverse_cuthill_mckee(sub, symmetric_mode=True)
        pos_rcm, bw_rcm = band_of(t_ids[perm])
        pos_int = bw_int = None
        variables = getattr(getattr(model, "core", None), "variables", None)
        if variables:
            frac = np.zeros(n)
            vid = np.zeros(n, dtype=np.int64)
            for v in variables:
                sl = slice(v.offset, v.offset + v.length)
                frac[sl] = np.arange(v.length) / max(v.length, 1)
                vid[sl] = v.vid
            key = np.lexsort((vid[t_ids], frac[t_ids]))
            pos_int, bw_int = band_of(t_ids[key])
        if bw_int is not None and bw_int < 0.66 * bw_rcm:
            pos, bw = pos_int, bw_int
        else:
            pos, bw = pos_rcm, bw_rcm
        bs = bt._round_up(max(bw, 1) + 1, 8)
        nb = max((nT + bs - 1) // bs, 1)
        if nb_round is not None:
            nb = max(int(nb_round(nb)), nb)
        slot[t_ids] = pos[t_ids]
        mode = "band"
    out.update(mode=mode, bs=bs, nb=nb)
    if not (bs <= max_block and nb >= min_blocks):
        return out
    nTpad = nb * bs
    rr, cc = rows, cols
    tt = t_mask[rr] & t_mask[cc]
    pr, pc = slot[rr], slot[cc]
    blk_r = np.where(pr >= 0, pr // bs, -9)
    blk_c = np.where(pc >= 0, pc // bs, -9)
    off_r, off_c = pr % bs, pc % bs
    selD = np.nonzero(tt & (blk_r == blk_c))[0]
    selL = np.nonzero(tt & (blk_r == blk_c + 1))[0]
    if tt.any() and (tt & (np.abs(blk_r - blk_c) > 1)).any():
        return out
    selB = np.nonzero(t_mask[rr] & border_mask[cc])[0]
    selC = np.nonzero(border_mask[rr] & border_mask[cc])[0]
    bpos = np.full(n, -1, dtype=np.int64)
    bpos[b_ids] = np.arange(mB)
    nnz = len(rows)
    out.update(
        usable=True, nTpad=nTpad,
        block_diag=(mode == "block_diag") or len(selL) == 0,
        D=numpy_gather_plan(
            blk_r[selD] * bs * bs + off_r[selD] * bs + off_c[selD], selD,
            nnz),
        L=numpy_gather_plan(
            blk_c[selL] * bs * bs + off_r[selL] * bs + off_c[selL], selL,
            nnz),
        B=numpy_gather_plan(pr[selB] * mB + bpos[cc[selB]], selB, nnz),
        C=numpy_gather_plan(bpos[rr[selC]] * mB + bpos[cc[selC]], selC,
                            nnz),
        slot=slot, t_ids=t_ids, b_ids=b_ids)
    tslot = slot[t_ids]
    dorder = np.argsort(tslot, kind="stable")
    occupied = np.zeros(nTpad, bool)
    occupied[tslot] = True
    slot_src = np.zeros(nTpad, np.int64)
    slot_src[tslot] = t_ids
    out_perm = np.zeros(n, np.int64)
    out_perm[t_ids] = tslot
    out_perm[b_ids] = nTpad + np.arange(mB)
    pad = (~occupied).astype(np.float64).reshape(nb, bs)
    out.update(
        diag_take=t_ids[dorder],
        diag_dest=(tslot[dorder] // bs) * bs * bs
        + (tslot[dorder] % bs) * (bs + 1),
        slot_src=slot_src, out_perm=out_perm,
        slot_mask=occupied.reshape(nb, bs).astype(np.float64),
        pad_eye=np.einsum("bi,ij->bij", pad, np.eye(bs)))
    return out


# ----------------------------------------------------------------------
# comparisons
# ----------------------------------------------------------------------
def assert_plan_equal(plan, buckets):
    """``plan`` (a :class:`SegmentSum`) holds ``buckets``' tables."""
    assert len(plan.tabs) == len(buckets)
    for tab, (want, _) in zip(plan.tabs, buckets):
        assert tab.dtype == torch.int64
        assert np.array_equal(tab.cpu().numpy(), want)
    u = (np.concatenate([u for _, u in buckets]) if buckets
         else np.zeros(0, np.int64))
    assert plan.u.dtype == torch.int64
    assert np.array_equal(plan.u.cpu().numpy(), u)


def assert_structure_equal(kkt, want):
    """The layout: every scalar the analysis decides, and the slots."""
    for name in ("n", "nT", "mB", "usable", "mode", "bs", "nb", "nTpad",
                 "block_diag"):
        if name in want:
            assert getattr(kkt, name) == want[name], name
    if want["usable"]:
        assert np.array_equal(kkt._slot_np, want["slot"])
        assert np.array_equal(kkt.t_ids_np, want["t_ids"])
        assert np.array_equal(kkt.b_ids_np, want["b_ids"])


def assert_tables_equal(kkt, want):
    """The device tables: the assembly plans, the diagonal and permutation
    gathers, the pad mask and the padding identity."""
    for name in "DLBC":
        assert_plan_equal(getattr(kkt, name + "_plan"), want[name])
    for name in ("diag_take", "diag_dest", "slot_src", "out_perm",
                 "slot_mask", "pad_eye"):
        got = getattr(kkt, name)
        assert got.device.type == torch.device(kkt.device).type, name
        if name in ("slot_mask", "pad_eye"):
            assert got.dtype == kkt.model.dtype, name
        else:
            assert got.dtype == torch.int64, name
        assert np.array_equal(got.cpu().numpy(), want[name]), name
    assert np.array_equal(kkt.b_ids.cpu().numpy(), want["b_ids"])


def pow2_rounding(nb):
    """A block count rounded as the sharded band rounds it for 4 ranks."""
    return 4 * 2 ** int(np.ceil(np.log2(-(-nb // 4))))


CASES = {
    "quad12": (lambda: tmodels.quad(num_supports=12), {}),
    "quad200": (lambda: tmodels.quad(num_supports=200), {}),
    "hovercraft41": (lambda: tmodels.hovercraft(num_supports=41), {}),
    "hovercraft41_blocks": (lambda: tmodels.hovercraft(num_supports=41),
                            dict(min_blocks=2)),
    "farmer64": (lambda: tmodels.farmer(num_scenarios=64), {}),
    "pandemic56x10": (lambda: tmodels.pandemic(num_supports=56,
                                               num_scenarios=10), {}),
    "opf10": (lambda: tmodels.opf(num_supports=10), {}),
    "opf100": (lambda: tmodels.opf(num_supports=100), {}),
    "design3node100": (lambda: tmodels.design_3node(num_scenarios=100), {}),
    # the border cut at max_border (numpy's argsort picks among equals)
    "farmer64_cut": (lambda: tmodels.farmer(num_scenarios=64),
                     dict(max_border=2, min_blocks=2)),
    "pandemic56x10_cut": (lambda: tmodels.pandemic(num_supports=56,
                                                   num_scenarios=10),
                          dict(max_border=40)),
    # the block count rounded up (the sharded band's padding blocks)
    "quad200_rounded": (lambda: tmodels.quad(num_supports=200),
                        dict(nb_round=pow2_rounding)),
}
# the layout each case takes: (mode, mB, usable).  opf-10 has no border
# (no degree above 32) and one component: a band of 3 blocks, too few, so
# the solver takes the dense KKT; farmer-64 with 2 of its 3 first-stage
# variables in the border is one band of 2 blocks of 256
MODES = {"quad12": ("band", 0, True), "quad200": ("band", 0, True),
         "hovercraft41": ("band", 0, True),
         "hovercraft41_blocks": ("block_diag", 0, True),
         "farmer64": ("block_diag", 3, True),
         "pandemic56x10": ("band", 66, True),
         "opf10": ("band", 0, False), "opf100": ("block_diag", 6, True),
         "design3node100": ("block_diag", 3, True),
         "farmer64_cut": ("band", 2, True),
         "pandemic56x10_cut": ("band", 40, True),
         "quad200_rounded": ("band", 0, True)}

_models = {}


def _model(build):
    if build not in _models:
        _models[build] = transcribe(build(), device="cpu")[0]
    return _models[build]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    build, kw = CASES[request.param]
    m = _model(build)
    return request.param, bt.BlockTridiagKKT(m, **kw), numpy_analysis(m, **kw)


def test_structure_equals_the_numpy_analysis(case):
    name, kkt, want = case
    assert (kkt.mode, kkt.mB, kkt.usable) == MODES[name]
    assert_structure_equal(kkt, want)
    if name == "quad200_rounded":
        assert kkt.nb == pow2_rounding(kkt.nb) > want["nT"] // kkt.bs


def test_tables_equal_the_numpy_analysis(case):
    name, kkt, want = case
    if not want["usable"]:
        assert not kkt.usable and not hasattr(kkt, "D_plan")
        assert isinstance(bt.make_structured_kkt(kkt.model, **CASES[name][1]),
                          DenseKKT)
        return
    assert_tables_equal(kkt, want)


# ----------------------------------------------------------------------
# the fallbacks
# ----------------------------------------------------------------------
@pytest.mark.parametrize("why", ["too_few_blocks", "band_too_wide",
                                 "entry_crosses_blocks"])
def test_unfit_structure_falls_back_to_dense(why, monkeypatch):
    m = _model(CASES["quad12"][0])
    kw = {"too_few_blocks": dict(min_blocks=100),
          "band_too_wide": dict(max_block=32)}.get(why, {})
    if why == "entry_crosses_blocks":
        # blocks of 8 under a band of ~60: entries two blocks and more
        # apart, which the block layout cannot hold
        monkeypatch.setattr(bt, "_round_up", lambda x, m: 8)
    kkt = bt.BlockTridiagKKT(m, **kw)
    want = numpy_analysis(m, **kw)
    assert not kkt.usable and not want["usable"]
    assert_structure_equal(kkt, want)
    if why == "entry_crosses_blocks":
        assert (kkt.bs, kkt.nb) == (8, -(-kkt.nT // 8))
    assert isinstance(bt.make_structured_kkt(m, **kw), DenseKKT)
    with pytest.raises(NotImplementedError):
        bt.make_structured_kkt(m, fallback=False, **kw)


# ----------------------------------------------------------------------
# gather_plan
# ----------------------------------------------------------------------
def _skewed(rng):
    """One destination of multiplicity 70,000 beside many of 1 to ~9."""
    dest = np.concatenate([np.full(70_000, 3, np.int64),
                           np.arange(100, 40_100),
                           rng.integers(50_000, 52_000, 9_000)])
    return dest[rng.permutation(len(dest))]


@pytest.mark.parametrize("stream", ["skewed", "skewed_selection",
                                    "powers_of_two", "single", "empty"])
def test_gather_plan_equals_the_numpy_plan(stream):
    rng = np.random.default_rng(3)
    sel, nnz_total = None, None
    if stream.startswith("skewed"):
        dest = _skewed(rng)
        if stream == "skewed_selection":
            sel = np.sort(rng.choice(300_000, len(dest), replace=False))
            nnz_total = 300_000
    elif stream == "powers_of_two":
        # multiplicities at and beside every power of two up to 2**12
        counts = [c for k in range(13) for c in (2 ** k - 1, 2 ** k,
                                                 2 ** k + 1) if c]
        dest = np.repeat(np.arange(len(counts)) * 5, counts)
        dest = dest[rng.permutation(len(dest))]
    elif stream == "single":
        dest = np.array([9])
    else:
        dest = np.zeros(0, np.int64)
    want = numpy_gather_plan(dest, sel, nnz_total)
    for d in (dest, torch.as_tensor(dest)):
        got = gather_plan(d, sel, nnz_total)
        assert len(got) == len(want)
        for (tab, u), (wtab, wu) in zip(got, want):
            assert tab.dtype == u.dtype == torch.int64
            assert np.array_equal(tab.numpy(), wtab)
            assert np.array_equal(u.numpy(), wu)
    size = int(dest.max()) + 1 if len(dest) else 4
    assert_plan_equal(SegmentSum(dest, size, "cpu", sel=sel,
                                 nnz_total=nnz_total), want)
