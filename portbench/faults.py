"""Faults planted in the program underneath a run, each of which the check
of ``correct`` has to catch.  Each is a context manager that patches the
program's classes and restores them on exit:

- ``state_unchanged``: the solve hands back its start point as its answer;
- ``answer_altered``: one entry of the answer moved by 1e-4 where the
  solver produces it;
- ``half_the_batch``: the second half of every support-indexed value
  (the time grid, the scenarios) filled from the first half;
- ``jacobian_scaled``: every value of the constraints' Jacobian from the
  AD sweeps (``jac_vals``, ``cons_and_jac``) off by a factor ``1 + 1e-3``,
  as a wrong constant in a derivative rule would leave it.  The KKT's own
  sweep (``kkt_vals``) stays right, so the solver still converges, to the
  right point with the right objective, and hands back duals a thousandth
  off: only the Lagrangian's gradient sees it.

One card, so no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

import numpy as np

JAC_FACTOR = 1.0 + 1e-3


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _solver():
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    return IpmSolver


def state_unchanged():
    def make(solve):
        def stuck(self, *a, **k):
            res = solve(self, *a, **k)
            res.solution = self.model.x0.detach().cpu().numpy().copy()
            return res
        return stuck
    return _patched(_solver(), "solve", make)


def answer_altered():
    def make(solve):
        def altered(self, *a, **k):
            res = solve(self, *a, **k)
            res.solution = np.array(res.solution, copy=True)
            res.solution[len(res.solution) // 2] += 1e-4
            return res
        return altered
    return _patched(_solver(), "solve", make)


def half_the_batch():
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend

    def make(value):
        def half(self, ref, label=None, **k):
            out = value(self, ref,
                        **({} if label is None else {"label": label}))
            arr = np.asarray(out)
            if arr.ndim == 1 and arr.size > 3:
                h = arr.size // 2
                arr = arr.copy()
                arr[h:2 * h] = arr[:h]
                return arr
            return out
        return half
    return _patched(ExaTranscriptionBackend, "map_value", make)


@contextlib.contextmanager
def jacobian_scaled():
    from infiniteexamodels_jl_torch.ops.model import SimdModel

    def make_jac(jac_vals):
        return lambda self, x, theta: jac_vals(self, x, theta) * JAC_FACTOR

    def make_cons_and_jac(cons_and_jac):
        def both(self, x, theta):
            c, jv = cons_and_jac(self, x, theta)
            return c, jv * JAC_FACTOR
        return both

    with _patched(SimdModel, "jac_vals", make_jac), \
            _patched(SimdModel, "cons_and_jac", make_cons_and_jac):
        yield


FAULTS = {f.__name__: f for f in (state_unchanged, answer_altered,
                                  half_the_batch, jacobian_scaled)}
