"""Lobatto orthogonal collocation and trapezoid quadrature, worked out
from their definitions (InfiniteOpt's ``OrthogonalCollocation(n)`` and
``UniTrapezoid``).

An interval ``[0, T]`` with ``N`` public supports on a uniform grid has
``N - 1`` elements; each element gets the ``n - 2`` interior Lobatto
nodes, so the full grid has ``(N - 1)(n - 1) + 1`` points, element ``e``
owning points ``e (n - 1) ... e (n - 1) + n - 1``.  On element ``e`` of
length ``h`` the degree-``(n - 1)`` interpolant of ``y`` obeys

    y(s_j) - y(s_0) = h * sum_k A[j - 1, k] * y'(s_k),   j = 1 .. n - 1,

with ``A[j - 1, k]`` the integral over ``[0, tau_j]`` of the ``k``-th
Lagrange basis polynomial on the unit element.
"""
from __future__ import annotations

import numpy as np


def lobatto_nodes(n):
    """Lobatto nodes on the unit element ``[0, 1]``: both ends and the
    roots of ``P'_{n-1}`` mapped from ``[-1, 1]``."""
    if n < 2:
        raise ValueError("a Lobatto rule needs two nodes or more")
    inner = np.polynomial.legendre.Legendre.basis(n - 1).deriv().roots()
    x = np.concatenate([[-1.0], np.sort(np.real(inner)), [1.0]])
    return (x + 1.0) / 2.0


def integration_matrix(n):
    """``A[j - 1, k] = int_0^{tau_j} ell_k(s) ds`` on the unit element."""
    tau = lobatto_nodes(n)
    A = np.zeros((n - 1, n))
    for k in range(n):
        others = np.delete(tau, k)
        ell = np.polynomial.Polynomial.fromroots(others) / np.prod(
            tau[k] - others)
        anti = ell.integ()
        A[:, k] = anti(tau[1:]) - anti(0.0)
    return A


def grid(num_supports, horizon, n):
    """(full grid, public mask): the uniform public supports with each
    element's interior Lobatto nodes between them."""
    public = np.linspace(0.0, horizon, num_supports)
    tau = lobatto_nodes(n)
    h = np.diff(public)
    inner = public[:-1, None] + h[:, None] * tau[None, 1:-1]
    full = np.concatenate([
        np.concatenate([public[:-1, None], inner], axis=1).reshape(-1),
        public[-1:]])
    mask = np.zeros(len(full), dtype=bool)
    mask[::n - 1] = True
    return full, mask


def trapezoid_weights(points):
    """Trapezoid weights over sorted points."""
    w = np.zeros(len(points))
    d = np.diff(points)
    w[:-1] += d / 2.0
    w[1:] += d / 2.0
    return w
