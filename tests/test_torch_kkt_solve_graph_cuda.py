"""The band and scenario KKT's solve as a CUDA graph
(``solvers/block_tridiag.py``) on the card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda \
        tests/test_torch_kkt_solve_graph_cuda.py

- quad-1000 (band, BCR) and opf-1000 (block-diagonal with a border of 6):
  the replayed solve equals the eager one bit for bit, on the capture's
  factorization and on a later one, for two right-hand sides; a solve
  with an older factorization raises;
- a quad-1000 solve and its warm re-solve with the graph match the eager
  ones in status, iterations and objective, and the warm request solves
  no system eagerly.
"""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.solvers.block_tridiag import (
    make_structured_kkt)
from infiniteexamodels_jl_torch.transcribe import transcribe
from infiniteexamodels_jl_torch.utils import timers

MODELS = {"quad-1000": lambda: tmodels.quad(num_supports=1000),
          "opf-1000": lambda: tmodels.opf(num_supports=1000)}
MODES = {"quad-1000": ("band", 0), "opf-1000": ("block_diag", 6)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request, card):
    m, _ = transcribe(MODELS[request.param](), device=card)
    kkt = make_structured_kkt(m)
    assert kkt._graphs.on and (kkt.mode, kkt.mB) == MODES[request.param]
    return m, kkt


def _K(kkt, seed, shift=0.0):
    """An SPD system of ``kkt``'s structure from a seeded point."""
    m = kkt.model
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=m.dtype, device=m.device)

    x = m.x0 + 0.01 * t(rng.standard_normal(m.nvar))
    return kkt.assemble(x, m.theta, t(0.1 * rng.standard_normal(m.ncon)),
                        1.0, t(rng.uniform(1.0, 3.0, m.ncon)),
                        t(rng.uniform(2.0, 4.0, m.nvar) + shift))


def _rhs(m, seed):
    g = torch.Generator(device=m.device).manual_seed(seed)
    return torch.randn(m.nvar, generator=g, dtype=m.dtype, device=m.device)


@pytest.mark.cuda
def test_a_replayed_solve_equals_the_eager_one(case):
    m, kkt = case
    r1, r2 = _rhs(m, 1), _rhs(m, 2)
    Ks = (_K(kkt, 1), _K(kkt, 2, shift=10.0))
    with timers.Recorder() as rec:
        for K in Ks:
            fac, ok = kkt.factor(K)
            assert bool(ok)
            first = kkt.solve(fac, r1)
            kept = first.clone()
            second = kkt.solve(fac, r2)
            assert torch.equal(first, kkt._eager_solve(fac, r1))
            assert torch.equal(second, kkt._eager_solve(fac, r2))
            assert torch.equal(first, kept)
            assert not torch.equal(first, second)
    assert rec.counts == {"kkt.solve_graph_captures": 1,
                          "kkt.solve_graph_replays": 3}
    kkt.factor(K)
    with pytest.raises(RuntimeError, match="stale factorization"):
        kkt.solve(fac, r1)


def _solve(card, graphed):
    """quad-1000 built, solved and re-solved warm, with the KKT's solve
    graphed or eager."""
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.solvers import IpmSolver

    class Solver(IpmSolver):
        def __init__(self, model, **options):
            super().__init__(model, **options)
            self.kkt._graphs.on = graphed

    m = tmodels.quad(num_supports=1000)
    backend = ExaTranscriptionBackend(Solver, device=card,
                                      linear_solver="auto", tol=1e-6,
                                      print_level=0)
    m.set_transformation_backend(backend)
    first = backend.optimize(m)
    return first, backend.optimize(m)


@pytest.mark.cuda
def test_a_quad_1000_solve_matches_the_eager_solve(card):
    eager, eager_warm = _solve(card, False)
    first, warm = _solve(card, True)
    assert first.status == eager.status == "first_order"
    assert warm.status == eager_warm.status == "first_order"
    assert first.iter == eager.iter and warm.iter == eager_warm.iter
    assert first.objective == eager.objective
    assert warm.objective == eager_warm.objective
    assert first.counts["kkt.solve_graph_captures"] == 1
    assert "kkt.solve_graph_captures" not in warm.counts
    assert "kkt.eager_solves" not in warm.counts
    assert warm.counts["kkt.solve_graph_replays"] == \
        eager_warm.counts["kkt.eager_solves"]
    assert "kkt.solve_graph_replays" not in eager.counts
