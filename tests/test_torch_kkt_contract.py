"""The IPM reaches a condensed-KKT backend through its contract alone
(``solvers/kkt.py``, ``CondensedKKT``): ``assemble``, ``factor``,
``solve``, ``matvec``, ``refinement`` and ``low_precision_view``.

A stand-in backend that has only these, each handing over to a
``DenseKKT``, takes quad-12 through the ``DenseKKT`` solve's iterates bit
for bit, in the f64 step set and in "mixed" (which, with no f32 view, runs
in f64), and the solver asks it for nothing else.
"""
import pytest
import torch

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.solvers import IpmSolver
from infiniteexamodels_jl_torch.solvers.kkt import DenseKKT, ReplicatedSpace
from infiniteexamodels_jl_torch.transcribe import transcribe


class ContractOnly:
    """The contract over a ``DenseKKT``; any other attribute the solver
    asks for is recorded in ``missed``."""

    def __init__(self, model):
        self.dense = DenseKKT(model)
        self.missed = []

    def __getattr__(self, name):
        self.missed.append(name)
        raise AttributeError(name)

    def assemble(self, x, theta, lam, sigma, d, diag_extra):
        return self.dense.assemble(x, theta, lam, sigma, d, diag_extra)

    def factor(self, K):
        return self.dense.factor(K)

    def solve(self, fac, rhs):
        return self.dense.solve(fac, rhs)

    def matvec(self, K, v):
        return self.dense.matvec(K, v)

    def refinement(self, fac, K):
        return ReplicatedSpace(self, fac, K)

    def low_precision_view(self):
        return None


class Recording(IpmSolver):
    """An IPM solver that keeps every state its steps reach."""

    def _step(self, st, consts, kkt=None):
        st = super()._step(st, consts, kkt)
        self.states.append(tuple(
            f.clone() if torch.is_tensor(f) else f for f in st))
        return st


def _solve(model, kkt, factor_dtype):
    solver = Recording(model, kkt=kkt, print_level=0,
                       factor_dtype=factor_dtype)
    solver.states = []
    return solver, solver.solve()


@pytest.mark.parametrize("factor_dtype", ["float64", "mixed"])
def test_a_backend_of_the_contract_alone_takes_the_dense_iterates(
        factor_dtype):
    model, _ = transcribe(tmodels.quad(num_supports=12), device="cpu")
    dense, want = _solve(model, DenseKKT(model), factor_dtype)
    stand_in = ContractOnly(model)
    solver, got = _solve(model, stand_in, factor_dtype)
    assert stand_in.missed == []
    assert solver.kkt32 is None
    assert got.status == want.status == "first_order"
    assert (got.iter, got.objective) == (want.iter, want.objective)
    assert len(solver.states) == len(dense.states) >= want.iter
    for a, b in zip(solver.states, dense.states):
        for u, v in zip(a, b):
            assert torch.equal(u, v) if torch.is_tensor(u) else u == v
