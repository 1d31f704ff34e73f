"""The port's host LDL (``linear_solver="ldl_cpp"``, alias ``"ma27"``):
``csrc/ldl.cpp`` built by the host C++ compiler into the port's ``_build/``
and bound by ``solvers/cpp_ldl.py``.

- ``SparseLDL`` on a seeded sparse SPD matrix against
  ``numpy.linalg.solve`` (rtol 1e-10), and an indefinite matrix: nonzero
  pivot count, ``ok`` false and a NaN solve through ``CppLdlKKT``;
- hovercraft-31 with ``ldl_cpp`` against the port's dense path and the JAX
  package's ``ldl_cpp`` (objective abs 1e-9, solution 1e-7, as
  tests/test_block_kkt.py::test_ipm_with_native_ldl_matches_dense holds
  the JAX package);
- ``"ma27"`` builds ``CppLdlKKT``; the loaded library lies under the
  port's ``_build/``; a source that does not compile raises.
"""
import pathlib

import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.backend import (
    ExaTranscriptionBackend as JBackend)
from infiniteexamodels_jl_tpu.solvers import IpmSolver as JIpmSolver
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers.cpp_ldl import (
    CppLdlKKT, SparseLDL, load_library)
from infiniteexamodels_jl_torch.transcribe import transcribe
from infiniteexamodels_jl_torch.utils import host_build


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = (rng.random((n, n)) < 0.06) * rng.standard_normal((n, n))
    return A @ A.T + np.eye(n), rng.standard_normal(n)


def test_sparse_ldl_solves_spd():
    K, b = _spd(80, 0)
    r, c = np.nonzero(K)
    assert len(r) < 0.5 * K.size          # sparse enough to mean it
    ldl = SparseLDL(len(K), r, c)
    assert ldl.factor(K[r, c]) == 0
    want = np.linalg.solve(K, b)
    np.testing.assert_allclose(ldl.solve(b), want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_indefinite_gives_nan():
    K, _ = _spd(80, 1)
    r, c = np.nonzero(K)
    ldl = SparseLDL(len(K), r, c)
    assert ldl.factor((K - 3.0 * np.eye(len(K)))[r, c]) != 0
    m, _ = transcribe(tmodels.hovercraft(num_supports=11), device="cpu")
    kkt = CppLdlKKT(m)
    K = kkt.assemble(m.x0, m.theta, torch.zeros(m.ncon), 1.0,
                     torch.ones(m.ncon), torch.full((m.nvar,), -1e3))
    fac, ok = kkt.factor(K)
    assert not bool(ok)
    assert torch.isnan(kkt.solve(fac, torch.ones(m.nvar))).all()


def _hovercraft31(Backend, Solver, M, **opts):
    m = M.hovercraft(num_supports=31)
    m.set_transformation_backend(Backend(Solver, **opts))
    m.set_silent()
    return m, m.optimize()


def test_hovercraft31_matches_dense_and_jax():
    m, ldl = _hovercraft31(ExaTranscriptionBackend, IpmSolver, tmodels,
                           device="cpu", linear_solver="ldl_cpp")
    assert type(m.backend.solver.kkt) is CppLdlKKT
    _, dense = _hovercraft31(ExaTranscriptionBackend, IpmSolver, tmodels,
                             device="cpu")
    _, jldl = _hovercraft31(JBackend, JIpmSolver, jmodels,
                            linear_solver="ldl_cpp")
    assert ldl.status == dense.status == jldl.status == "first_order"
    for other in (dense, jldl):
        assert ldl.objective == pytest.approx(other.objective, abs=1e-9)
        np.testing.assert_allclose(ldl.solution, other.solution, atol=1e-7)


def test_ma27_alias_and_library_location():
    m, _ = transcribe(tmodels.hovercraft(num_supports=11), device="cpu")
    assert type(IpmSolver(m, linear_solver="ma27").kkt) is CppLdlKKT
    path = pathlib.Path(load_library()._name).resolve()
    assert path.parent == host_build.BUILD_DIR.resolve()
    assert path == host_build.library_path("ldl").resolve()
    assert "native" not in path.parts


def test_failed_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(host_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        host_build.load("broken")
    assert not host_build.library_path("broken").exists()
