"""Shared arithmetic of the first-order optimality check.

The multipliers follow JuMP's convention, which the program's ``dual``
queries report: for ``min f(x)`` subject to ``l <= c(x) <= u`` and
``xl <= x <= xu``, stationarity is

    grad f(x) - J(x)^T lam - zl + zu = 0,    zl, zu >= 0,

with ``lam`` the dual of each row and ``zl``, ``zu`` the duals of the
variable bounds.  The dual infeasibility is scaled as Ipopt and MadNLP
scale it (``s_d``), so that it reads on the scale of the solver's ``tol``.
"""
from __future__ import annotations

import numpy as np

S_MAX = 100.0


def dual_scale(multipliers, count):
    """Ipopt's ``s_d = max(s_max, (|lam|_1 + |z|_1) / (m + n)) / s_max``."""
    total = sum(float(np.abs(np.asarray(v, dtype=np.float64)).sum())
                for v in multipliers)
    return max(S_MAX, total / max(count, 1)) / S_MAX


def relative_gap(a, b):
    """``|a - b| / max(1, |b|)``."""
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def range_violation(g, lo, hi):
    """Largest amount by which ``g`` leaves ``[lo, hi]`` (0 inside)."""
    g = np.asarray(g, dtype=np.float64)
    return float(np.max(np.maximum(np.maximum(lo - g, g - hi), 0.0),
                        initial=0.0))


def range_complementarity(g, lo, hi, lam):
    """Largest ``|lam| * slack`` to the side that the sign of ``lam`` names
    (a positive dual pushes from the lower side, a negative one from the
    upper side, in JuMP's convention)."""
    g = np.asarray(g, dtype=np.float64)
    lam = np.asarray(lam, dtype=np.float64)
    lo_slack = np.where(np.isfinite(lo), g - lo, np.inf)
    hi_slack = np.where(np.isfinite(hi), hi - g, np.inf)
    slack = np.where(lam >= 0, lo_slack, hi_slack)
    prod = np.where(np.isfinite(slack), np.abs(lam) * np.abs(slack),
                    np.abs(lam) * np.inf)
    prod = np.where(lam == 0, 0.0, prod)
    return float(np.max(prod, initial=0.0))
