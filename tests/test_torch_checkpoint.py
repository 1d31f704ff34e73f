"""Checkpoint and resume, the profiler trace and the option surface of the
port's ``IpmSolver``, against the JAX package's on the CPU.

- a solve cut at iteration 4 by ``max_iter`` with ``checkpoint_every=2``,
  then resumed, ends at the uninterrupted solve's final ``x``, bit for
  bit, in as many iterations (farmer-32: hovercraft-31 converges in 3);
- a JAX-written checkpoint resumes in the port to the JAX objective (abs
  1e-9), and a port-written one resumes in the JAX package (hovercraft-31);
- a checkpoint without ``log_rr`` loads (as
  tests/test_untested_surface.py::test_checkpoint_without_log_fields_loads);
- ``trace_dir`` writes a Chrome trace on the CPU;
- every key of the JAX package's ``DEFAULTS`` is the port's, with its
  value, and ``MadIpmSolver`` defaults to ``"auto"``.
"""
import json

import numpy as np
import pytest
import torch

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_tpu.solvers import ipm as jipm
from infiniteexamodels_jl_tpu.transcribe import transcribe as jtranscribe
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.solvers import ipm as tipm
from infiniteexamodels_jl_torch.solvers import IpmSolver, MadIpmSolver
from infiniteexamodels_jl_torch.solvers.block_tridiag import BlockTridiagKKT
from infiniteexamodels_jl_torch.transcribe import transcribe


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: small tensors, and several test workers share
    the cores (each with its own OpenMP pool otherwise)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_resume_is_bit_identical(tmp_path):
    m, _ = transcribe(tmodels.farmer(num_scenarios=32), device="cpu")
    full = IpmSolver(m, linear_solver="auto", print_level=0).solve()
    s = IpmSolver(m, linear_solver="auto", print_level=0)
    ckpt = str(tmp_path / "st.npz")
    cut = s.solve(checkpoint_path=ckpt, checkpoint_every=2, max_iter=4)
    assert cut.status == "max_iter" and cut.iter == 4
    st = s.load_checkpoint(ckpt)
    assert int(st.iter) == 4 and st.iter.dtype == torch.int32
    res = s.solve(resume_from=ckpt, max_iter=3000)
    assert res.status == full.status == "first_order"
    assert res.iter == full.iter > 32          # past a host round-trip
    np.testing.assert_array_equal(res.solution, full.solution)


def test_checkpoints_cross_between_packages(tmp_path):
    jm, _ = jtranscribe(jmodels.hovercraft(num_supports=31))
    tm, _ = transcribe(tmodels.hovercraft(num_supports=31), device="cpu")
    js = jipm.IpmSolver(jm, print_level=0)
    ts = IpmSolver(tm, print_level=0)
    want = js.solve()
    assert want.status == "first_order" and want.iter > 2
    jck, tck = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    js.solve(checkpoint_path=jck, checkpoint_every=1, max_iter=2)
    ts.solve(checkpoint_path=tck, checkpoint_every=1, max_iter=2)
    with np.load(jck) as a, np.load(tck) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype == b[k].dtype for k in a.files)
    port = ts.solve(resume_from=jck, max_iter=3000)
    back = js.solve(resume_from=tck, max_iter=3000)
    for r in (port, back):
        assert r.status == "first_order"
        assert r.objective == pytest.approx(want.objective, abs=1e-9)


def test_checkpoint_without_log_rr_loads(tmp_path):
    m, _ = transcribe(tmodels.hovercraft(num_supports=31), device="cpu")
    s = IpmSolver(m, linear_solver="auto", print_level=0)
    ckpt = str(tmp_path / "st.npz")
    s.solve(checkpoint_path=ckpt, checkpoint_every=2, max_iter=4)
    with np.load(ckpt) as f:
        data = dict(f)
    data.pop("log_rr")
    np.savez(ckpt, **data)
    st = s.load_checkpoint(ckpt)
    assert float(st.log_rr) == 0.0 and st.log_rr.dtype == torch.float64
    assert s.solve(resume_from=ckpt).status == "first_order"


def test_trace_dir_writes_a_trace(tmp_path):
    m, _ = transcribe(tmodels.hovercraft(num_supports=11), device="cpu")
    res = IpmSolver(m, print_level=0).solve(trace_dir=tmp_path / "trace")
    assert res.status == "first_order"
    with open(tmp_path / "trace" / tipm.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_options_cover_the_jax_defaults():
    assert set(jipm.DEFAULTS) == set(tipm.DEFAULTS)
    for k, v in jipm.DEFAULTS.items():
        assert tipm.DEFAULTS[k] == v, k


def test_mad_ipm_solver_defaults_to_auto():
    m, _ = transcribe(tmodels.quad(num_supports=12), device="cpu")
    s = MadIpmSolver(m)
    assert s.opts["linear_solver"] == "auto"
    assert type(s.kkt) is BlockTridiagKKT
    assert MadIpmSolver(m, linear_solver="dense").opts[
        "linear_solver"] == "dense"
