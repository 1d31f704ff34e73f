"""The PyTorch port's transcription against the JAX package's: the same
model built in both packages must give EQUAL static tables (family gather
indices and data, bounds, starts, parameters, Jacobian/Hessian patterns)."""
import numpy as np
import pytest

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.transcribe import transcribe as ttranscribe

CASES = {
    # orthogonal collocation (the benchmark's main path)
    "quad12": lambda M: M.quad(num_supports=12),
    # backward finite differences
    "hovercraft41": lambda M: M.hovercraft(num_supports=41),
}


def _both(case):
    build = CASES[case]
    jm, jdata = jtranscribe(build(jmodels))
    tm, tdata = ttranscribe(build(tmodels), device="cpu")
    return jm, tm


@pytest.mark.parametrize("case", sorted(CASES))
def test_family_tables_equal(case):
    jm, tm = _both(case)
    assert (jm.nvar, jm.ncon, jm.ntheta) == (tm.nvar, tm.ncon, tm.ntheta)
    jf = jm.con_fams + jm.obj_fams
    tf = tm.con_fams + tm.obj_fams
    assert len(jf) == len(tf)
    for a, b in zip(jf, tf):
        assert (a.name, a.n, a.kx, a.kp, a.kf, a.offset) == \
            (b.name, b.n, b.kx, b.kp, b.kf, b.offset)
        assert np.array_equal(a.vidx, b.vidx)
        assert np.array_equal(a.pidx, b.pidx)
        assert np.array_equal(a.fdata, b.fdata)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bounds_starts_and_patterns_equal(case):
    jm, tm = _both(case)
    assert np.array_equal(jm._lcon_np, tm._lcon_np)
    assert np.array_equal(jm._ucon_np, tm._ucon_np)
    for name in ("x0", "lvar", "uvar", "theta"):
        assert np.array_equal(np.asarray(getattr(jm, name)),
                              getattr(tm, name).numpy()), name
    for name in ("jac_rows_np", "jac_cols_np", "hess_rows_np",
                 "hess_cols_np"):
        assert np.array_equal(getattr(jm, name), getattr(tm, name)), name
