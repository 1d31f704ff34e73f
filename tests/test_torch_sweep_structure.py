"""The port's transcription and KKT analysis at the ESCAPE34 sweep's sizes
against the JAX package's: ``ParameterGroup.add_supports`` (the port's is a
sorted merge, the JAX package's inserts one value at a time) gives exactly
the same supports and labels on seeded inputs; quad-2000's transcription
tables are equal; ``BlockTridiagKKT`` analyses quad-4000 (and, slow,
quad-16000) into the same band, block size, border and slot permutation;
and quad-16000's port build on the CPU, timed and printed."""
import time

import numpy as np
import pytest

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.modeling import InfiniteModel as JModel
from infiniteexamodels_jl_tpu.solvers.block_tridiag import (
    BlockTridiagKKT as JBlockKKT)
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.modeling import InfiniteModel as TModel
from infiniteexamodels_jl_torch.modeling.refs import (
    INTERNAL_COLLOCATION, INTERNAL_QUADRATURE, MC_SAMPLE, USER_DEFINED)
from infiniteexamodels_jl_torch.solvers.block_tridiag import BlockTridiagKKT
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe


def _batches(case, rng):
    """(start supports, [(values, label), ...]) of one seeded case."""
    grid = np.linspace(0.0, 1.0, 11)
    if case == "sorted":
        return grid, [(np.sort(rng.uniform(0, 1, 50)), USER_DEFINED)]
    if case == "unsorted":
        return grid, [(rng.uniform(0, 1, 50), USER_DEFINED),
                      (rng.uniform(-1, 2, 30), MC_SAMPLE)]
    if case == "duplicates":
        # exact repeats of old and of new values, values 1e-13 off old
        # supports, and new values within 1e-12 of each other (the first
        # in input order stays)
        new = rng.uniform(0, 1, 20)
        vals = np.concatenate([new, new[:5], new[5:9] + 5e-13,
                               new[9:12] - 3e-13, grid[2:6],
                               grid[6:9] + 1e-13, grid[9:] - 4e-13,
                               [0.0, -0.0, -0.0]])
        return grid, [(rng.permutation(vals), USER_DEFINED),
                      (np.array([-0.0, 2.0, 2.0 + 2e-13]), MC_SAMPLE)]
    if case == "near_chains":
        # distinct values closer than 1e-12: the order of insertion decides
        # which survive (both packages insert these one at a time)
        base = rng.uniform(0, 1, 8)
        vals = np.concatenate([base, base + 6e-13, base - 6e-13,
                               base + 1.2e-12])
        return grid, [(rng.permutation(vals), USER_DEFINED)]
    if case == "internal_drop":
        # internal nodes first, then a batch with one new public support
        # (drops them), then internal nodes again and a batch of old
        # supports only (keeps them)
        nodes = np.sort(rng.uniform(0, 1, 12))
        return grid, [(nodes, INTERNAL_COLLOCATION),
                      (nodes[:3], USER_DEFINED),
                      (np.concatenate([grid[:4], [0.123456]]),
                       USER_DEFINED),
                      (nodes[3:9], INTERNAL_QUADRATURE),
                      (grid[4:7], USER_DEFINED),
                      (nodes[3:5], MC_SAMPLE)]
    if case == "empty_start":
        return None, [(rng.uniform(0, 1, 40), USER_DEFINED),
                      (np.zeros(0), USER_DEFINED),
                      (rng.uniform(0, 1, 40), INTERNAL_COLLOCATION)]
    raise KeyError(case)


ADD_CASES = ("sorted", "unsorted", "duplicates", "near_chains",
             "internal_drop", "empty_start")


def _group(Model, start):
    m = Model()
    if start is None:
        t = m.infinite_parameter("t", domain=(0, 1))
    else:
        t = m.infinite_parameter("t", domain=(0, 1), supports=start)
    return t.group


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", ADD_CASES)
def test_add_supports_matches_jax(case, seed):
    """Supports bit for bit (signs of zero included), label sets, and the
    internal-node flags equal after every batch."""
    start, batches = _batches(case, np.random.default_rng(seed))
    groups = [_group(JModel, start), _group(TModel, start)]
    for values, label in batches:
        for g in groups:
            g.add_supports(values.copy(), label)
        jg, tg = groups
        assert jg._supports.dtype == tg._supports.dtype == np.float64
        assert jg._supports.tobytes() == tg._supports.tobytes()
        assert jg._labels == tg._labels
        assert (jg.has_internal, jg._generative_done) == \
            (tg.has_internal, tg._generative_done)


def test_quad2000_tables_equal():
    jm, _ = jtranscribe(jmodels.quad(num_supports=2000))
    tm, _ = ttranscribe(tmodels.quad(num_supports=2000), device="cpu")
    assert (jm.nvar, jm.ncon, jm.ntheta) == (tm.nvar, tm.ncon, tm.ntheta)
    for a, b in zip(jm.con_fams + jm.obj_fams, tm.con_fams + tm.obj_fams):
        assert (a.name, a.n, a.kx, a.kp, a.kf, a.offset) == \
            (b.name, b.n, b.kx, b.kp, b.kf, b.offset)
        for name in ("vidx", "pidx", "fdata"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert np.array_equal(jm._lcon_np, tm._lcon_np)
    assert np.array_equal(jm._ucon_np, tm._ucon_np)
    for name in ("x0", "lvar", "uvar", "theta"):
        assert np.array_equal(np.asarray(getattr(jm, name)),
                              getattr(tm, name).numpy()), name
    for name in ("jac_rows_np", "jac_cols_np", "hess_rows_np",
                 "hess_cols_np"):
        assert np.array_equal(getattr(jm, name), getattr(tm, name)), name


def _kkt_structure_matches(n, nb):
    jm, _ = jtranscribe(jmodels.quad(num_supports=n))
    tm, _ = ttranscribe(tmodels.quad(num_supports=n), device="cpu")
    jb, tb = JBlockKKT(jm), BlockTridiagKKT(tm)
    assert jb.usable and tb.usable
    assert (tb.mode, tb.nb, tb.bs, tb.mB) == ("band", nb, 64, 0)
    assert (jb.mode, jb.nb, jb.bs, jb.mB, jb.block_diag) == \
        (tb.mode, tb.nb, tb.bs, tb.mB, tb.block_diag)
    assert np.array_equal(jb._slot_np, tb._slot_np)
    for name in ("slot_src", "out_perm"):
        assert np.array_equal(np.asarray(getattr(jb, name)),
                              getattr(tb, name).numpy()), name


def test_quad4000_kkt_structure_matches_jax():
    _kkt_structure_matches(4000, 2750)


@pytest.mark.slow
def test_quad16000_kkt_structure_matches_jax():
    _kkt_structure_matches(16000, 11000)


def test_quad16000_port_build_time(record_property):
    """quad-16000 through the port's transcription on the CPU: its size,
    and the seconds of the build and of the KKT analysis, printed (20.4 s
    and 4.7 s on an 8-core CPU when add_supports inserted one value at a
    time)."""
    t0 = time.time()
    tm, _ = ttranscribe(tmodels.quad(num_supports=16000), device="cpu")
    build_s = time.time() - t0
    t0 = time.time()
    kkt = BlockTridiagKKT(tm)
    analysis_s = time.time() - t0
    assert (tm.nvar, tm.ncon) == (703978, 639978)
    assert (kkt.mode, kkt.nb, kkt.bs, kkt.mB) == ("band", 11000, 64, 0)
    assert kkt.k1_launches_per_factorization() == 15
    record_property("quad16000_build_s", build_s)
    record_property("quad16000_kkt_analysis_s", analysis_s)
    print(f"quad-16000 port build {build_s:.2f} s, KKT analysis "
          f"{analysis_s:.2f} s")
