"""The port's deterministic segment sum (ops/segsum.py): its tables stay
within twice the value stream whatever the largest multiplicity is, its sums
and maxima equal numpy's ``add.at``/``maximum.at``, two calls are
bit-identical, and on opf-1000's SimdModel (a first-stage variable in every
scenario row) the four plans hold under 3x their value streams."""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.ops.segsum import SegmentSum, gather_plan
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe


@pytest.fixture(scope="module")
def skewed():
    """One destination of multiplicity 100,000 and 100,000 destinations of
    multiplicity 1, interleaved, plus a stretch of small multiplicities."""
    rng = np.random.default_rng(0)
    n1 = 100_000
    dest = np.concatenate([np.zeros(n1, np.int64),
                           np.arange(1, n1 + 1),
                           rng.integers(n1 + 1, n1 + 500, 3_000)])
    dest = dest[rng.permutation(len(dest))]
    vals = rng.standard_normal(len(dest)) * 10.0 ** rng.integers(
        -3, 4, len(dest))
    return dest, vals, n1 + 500


def test_tables_at_most_twice_the_stream(skewed):
    dest, _, size = skewed
    plan = SegmentSum(dest, size, "cpu")
    n_unique = len(np.unique(dest))
    assert plan.entries <= 2 * len(dest) + n_unique
    # the old single padded table would hold n_unique * 100,000 entries
    assert plan.entries < 1e-3 * n_unique * 100_000
    widths = [t.shape[1] for t in plan.tabs]
    assert widths == sorted(widths) and widths[0] == 1
    assert widths[-1] == 131_072          # next power of two of 100,000


def test_sums_match_add_at_and_repeat_bit_identical(skewed):
    dest, vals, size = skewed
    plan = SegmentSum(dest, size, "cpu")
    got = plan(torch.as_tensor(vals)).numpy()
    want = np.zeros(size)
    np.add.at(want, dest, vals)
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    again = plan(torch.as_tensor(vals)).numpy()
    assert np.array_equal(got.view(np.int64), again.view(np.int64))


def test_amax_matches_maximum_at(skewed):
    dest, vals, size = skewed
    plan = SegmentSum(dest, size, "cpu")
    a = np.abs(vals)
    got = plan(torch.as_tensor(a), reduce="amax").numpy()
    want = np.zeros(size)
    np.maximum.at(want, dest, a)
    assert np.array_equal(got, want)


def test_selection_keeps_original_order_and_sentinel():
    dest = np.array([5, 2, 5, 5, 9, 2])
    sel = np.array([10, 11, 12, 13, 14, 15])
    buckets = gather_plan(dest, sel, nnz_total=20)
    rows = {int(d): list(r) for tab, u in buckets for d, r in zip(u, tab)}
    assert rows == {9: [14], 2: [11, 15], 5: [10, 12, 13, 20]}
    assert gather_plan(np.zeros(0, np.int64)) == []
    empty = SegmentSum(np.zeros(0, np.int64), 3, "cpu")
    assert torch.equal(empty(torch.zeros(0, dtype=torch.float64)),
                       torch.zeros(3, dtype=torch.float64))


def test_opf1000_plans_under_three_times_the_streams():
    tm, _ = ttranscribe(tmodels.opf(num_supports=1000), device="cpu")
    plans = (tm._grad_plan, tm._hvp_plan, tm._jprod_plan, tm._jtprod_plan)
    streams = (sum(f.n * f.kx for f in tm.obj_fams),
               sum(f.n * f.kx for f in tm.con_fams + tm.obj_fams),
               len(tm.jac_rows_np), len(tm.jac_cols_np))
    assert tm.nvar == 24_024
    for plan, stream in zip(plans, streams):
        assert plan.entries <= 3 * stream, (plan.entries, stream)
    # the first-stage variables sit in every scenario's rows: the widest
    # bucket holds only them (6 rows, one per pg0/qg0), 1,024 wide
    assert tuple(tm._hvp_plan.tabs[-1].shape) == (6, 1024)
    rng = np.random.default_rng(1)
    w = torch.as_tensor(rng.standard_normal(tm.ncon))
    jv = torch.as_tensor(rng.standard_normal(len(tm.jac_rows_np)))
    got = tm.jtprod(jv, w).numpy()
    want = np.zeros(tm.nvar)
    np.add.at(want, tm.jac_cols_np, jv.numpy() * w.numpy()[tm.jac_rows_np])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-12)
