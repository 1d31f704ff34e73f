"""Derivative discretization methods.

The reference supports FiniteDifference(Forward/Central/Backward) and
OrthogonalCollocation(n) with Gauss-Lobatto nodes (call sites:
InfiniteExaModels.jl/examples/hovercraft_example.jl:8-9,
ESCAPE34/quadrotor.jl:13-14; equations produced upstream by
InfiniteOpt.derivative_expr_data / make_indexed_derivative_expr, consumed at
InfiniteExaModels.jl/src/transform.jl:535-557).  Here each method produces its
stencil data directly: row index arrays plus coefficient columns that become
iterator fields of one SIMD equality family per derivative variable.
"""
from __future__ import annotations

import numpy as np


class Forward:
    pass


class Central:
    pass


class Backward:
    pass


class FiniteDifference:
    """First-order finite differences over the (sorted) support grid."""

    def __init__(self, scheme=Backward()):
        if isinstance(scheme, type):
            scheme = scheme()
        self.scheme = scheme
        self.generative_nodes = 0

    def __repr__(self):
        return f"FiniteDifference({type(self.scheme).__name__})"

    def stencil(self, supps):
        """Return (rows, cols_dict) for the defining equations
        d[i]*h_i - (y[a_i] - y[b_i]) == 0:

        rows   : support index of the derivative variable being defined
        a, b   : support indices of the two state samples
        h      : float column, the difference step
        """
        n = len(supps)
        s = np.asarray(supps)
        if isinstance(self.scheme, Backward):
            rows = np.arange(1, n)
            a, b = rows, rows - 1
            h = s[rows] - s[rows - 1]
        elif isinstance(self.scheme, Forward):
            rows = np.arange(0, n - 1)
            a, b = rows + 1, rows
            h = s[rows + 1] - s[rows]
        elif isinstance(self.scheme, Central):
            rows = np.arange(1, n - 1)
            a, b = rows + 1, rows - 1
            h = s[rows + 1] - s[rows - 1]
        else:
            raise ValueError(f"unknown FD scheme {self.scheme!r}")
        return rows, {"a": a, "b": b}, {"h": h}


def gauss_lobatto_nodes(n):
    """Gauss-Lobatto nodes on [-1, 1] (n >= 2): +-1 and the roots of
    P'_{n-1}."""
    if n < 2:
        raise ValueError("Lobatto rule needs >= 2 nodes")
    if n == 2:
        return np.array([-1.0, 1.0])
    # roots of derivative of Legendre polynomial P_{n-1}
    Pn = np.polynomial.legendre.Legendre.basis(n - 1)
    inner = Pn.deriv().roots()
    return np.concatenate([[-1.0], np.sort(inner.real), [1.0]])


def lobatto_integration_matrix(n):
    """M[j, k] = integral over [x0, x_j] of Lagrange basis ell_k, for the
    Lobatto nodes on [-1, 1], j = 1..n-1, k = 0..n-1 (scaled to a unit-length
    element by the caller).

    These encode the exactness relation of the degree-(n-1) interpolant:
        y(s_j) - y(s_0) = sum_k M[j, k] * y'(s_k)
    which is the collocation equation family imposed per element.
    """
    x = gauss_lobatto_nodes(n)
    M = np.zeros((n - 1, n))
    for k in range(n):
        # Lagrange basis ell_k over nodes x
        c = np.array([1.0])
        denom = 1.0
        for i in range(n):
            if i == k:
                continue
            c = np.convolve(c, np.array([1.0, -x[i]]))
            denom *= (x[k] - x[i])
        poly = np.polynomial.Polynomial(c[::-1] / denom)
        anti = poly.integ()
        for j in range(1, n):
            M[j - 1, k] = anti(x[j]) - anti(x[0])
    # scale from [-1,1] (length 2) to a unit-length element
    return M / 2.0


class OrthogonalCollocation:
    """Lobatto orthogonal collocation with ``n`` nodes per element (matching
    the reference's OrthogonalCollocation(n), e.g. ESCAPE34/quadrotor.jl:13).
    Adds n-2 internal (generative) supports per interval of public supports.
    """

    def __init__(self, n):
        if n < 2:
            raise ValueError("OrthogonalCollocation needs n >= 2")
        self.n = int(n)
        self.generative_nodes = self.n - 2

    def __repr__(self):
        return f"OrthogonalCollocation({self.n})"

    def internal_nodes(self, supps):
        """Internal collocation nodes for each interval of ``supps``
        (the generative supports, reference add_generative_supports at
        transform.jl:22)."""
        if self.generative_nodes == 0:
            return np.zeros(0)
        ref = gauss_lobatto_nodes(self.n)[1:-1]  # in (-1, 1)
        s = np.asarray(supps)
        lo, hi = s[:-1], s[1:]
        # map to each interval; result ordered by interval then node
        pts = (lo[:, None] + (ref[None, :] + 1.0) * 0.5 *
               (hi - lo)[:, None])
        return pts.reshape(-1)

    def stencil(self, supps):
        """Defining-equation data over the FULL sorted support vector
        (public + internal), which has layout
        [p_0, i_0_1..i_0_k, p_1, i_1_1.., p_2, ...] with k = n-2.

        Equations per element e with node indices e0..e_{n-1}:
           for j = 1..n-1:
             y[e_j] - y[e_0] - h_e * sum_k M[j,k] d[e_k] == 0

        Returned as (rows, int_cols, float_cols):
        rows      : the support index e_j (where the equation is anchored;
                    one equation per non-initial node == one per d unknown
                    beyond the first)
        int cols  : n columns c0..c{n-1} with the element's node indices
        float cols: n columns w0..w{n-1} with h_e*M[j, :]
        """
        n = self.n
        s = np.asarray(supps)
        nel = (len(s) - 1) // (n - 1)
        if nel * (n - 1) + 1 != len(s):
            raise ValueError(
                "support layout inconsistent with collocation elements")
        M = lobatto_integration_matrix(n)
        rows, icols, fcols = [], {f"c{k}": [] for k in range(n)}, \
            {f"w{k}": [] for k in range(n)}
        acol, bcol = [], []
        for e in range(nel):
            base = e * (n - 1)
            nodes = base + np.arange(n)
            h = s[nodes[-1]] - s[nodes[0]]
            for j in range(1, n):
                rows.append(nodes[j])
                acol.append(nodes[j])
                bcol.append(nodes[0])
                for k in range(n):
                    icols[f"c{k}"].append(nodes[k])
                    fcols[f"w{k}"].append(h * M[j - 1, k])
        icols = {k: np.asarray(v) for k, v in icols.items()}
        fcols = {k: np.asarray(v) for k, v in fcols.items()}
        icols["a"] = np.asarray(acol)
        icols["b"] = np.asarray(bcol)
        return np.asarray(rows), icols, fcols
