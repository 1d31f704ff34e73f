"""Measure operators: integral, expectation, support sum, derivative.

API parity with the operators the reference models use
(examples/pandemic.jl:26 `integral`, examples/2stage_example.jl:30 `E`,
examples/3node_design.jl:22 `expect`, `deriv`/`∂` everywhere).  Measure
coefficients are evaluated lazily at transcription time over the group's
public supports:

- integral: trapezoid weights over the sorted public supports (InfiniteOpt's
  default UniTrapezoid evaluation)
- expect:   1/N Monte-Carlo weights
- support_sum: unit weights
"""
from __future__ import annotations

import numpy as np

from .expr import as_expr
from .refs import (InfiniteParameter, MeasureRef, DerivativeRef, InfiniteVar,
                   SemiInfiniteVar)


def _group_of(pref_or_vec):
    if isinstance(pref_or_vec, InfiniteParameter):
        return pref_or_vec.group
    if isinstance(pref_or_vec, (list, tuple)) and pref_or_vec and \
            all(isinstance(p, InfiniteParameter) for p in pref_or_vec):
        g = pref_or_vec[0].group
        if any(p.group is not g for p in pref_or_vec) or \
                len(pref_or_vec) != g.dim:
            raise ValueError(
                "measures over dependent parameters must use the full vector")
        return g
    raise TypeError(f"expected infinite parameter(s), got {pref_or_vec!r}")


def _measure(kind, expr, pref, weight_fn=None, method="trapezoid",
             num_nodes=None):
    expr = as_expr(expr)
    group = _group_of(pref)
    model = group.model
    model._mark_dirty()
    return MeasureRef(model, expr, group, kind, weight_fn, method=method,
                      num_nodes=num_nodes)


def integral(expr, pref, weight_fn=None, method="trapezoid", num_nodes=None):
    """Integral measure over a scalar interval parameter.

    ``method="trapezoid"`` (default, InfiniteOpt's UniTrapezoid role)
    weights the group's PUBLIC supports; ``method="gauss_legendre"``
    instead adds ``num_nodes`` (default 20) Gauss-Legendre quadrature
    points over the interval as INTERNAL supports (the reference measure
    generality, InfiniteOpt eval-method quadratures; weights from the
    measure data feed the SIMD sum exactly like transform.jl:618-633) --
    exact for polynomial integrands up to degree 2*num_nodes-1 and
    excluded from public value queries."""
    if method == "gauss_legendre":
        group = _group_of(pref)
        k = int(num_nodes or 20)
        group.quadrature_nodes.add(k)
        group._generative_done = False
        return _measure("integral", expr, pref, weight_fn,
                        method=method, num_nodes=k)
    if method != "trapezoid":
        raise ValueError(f"unknown integral method {method!r}")
    return _measure("integral", expr, pref, weight_fn)


def expect(expr, pref, weight_fn=None):
    return _measure("expect", expr, pref, weight_fn)


def support_sum(expr, pref, weight_fn=None):
    return _measure("support_sum", expr, pref, weight_fn)


def measure_coefficients(mref):
    """(support_indices, coefficients) over the group's support vector,
    evaluated at transcription time (reference _make_measure_itr,
    transform.jl:618-633).  Only public supports participate; internal
    collocation nodes are excluded."""
    g = mref.group
    if mref.kind == "integral" and mref.method == "gauss_legendre":
        # quadrature nodes were added as internal supports at build time;
        # locate them in the support vector by value
        nodes, w = g.gauss_legendre_points(mref.num_nodes)
        allsup = g.supports()
        idxs = np.searchsorted(allsup, nodes)
        idxs = np.clip(idxs, 0, len(allsup) - 1)
        # searchsorted may land one slot right of the stored duplicate
        left_ok = (idxs > 0) & (np.abs(allsup[np.maximum(idxs - 1, 0)]
                                       - nodes) < 1e-9)
        idxs = np.where(np.abs(allsup[idxs] - nodes) < 1e-9, idxs,
                        np.where(left_ok, idxs - 1, idxs))
        if np.any(np.abs(allsup[idxs] - nodes) > 1e-9):
            raise ValueError("Gauss-Legendre nodes missing from supports; "
                             "was the model re-built after adding them?")
        coeffs = w
        if mref.weight_fn is not None:
            coeffs = coeffs * np.asarray(
                [mref.weight_fn(s) for s in nodes])
        return idxs, coeffs
    mask = g.public_mask()
    idxs = np.nonzero(mask)[0]
    supps = g.supports()[mask]
    if mref.kind == "integral":
        if not g.scalar:
            raise ValueError("integral over a dependent parameter vector")
        # supports of a scalar group are sorted: trapezoid weights
        s = supps
        w = np.zeros(len(s))
        if len(s) > 1:
            d = np.diff(s)
            w[:-1] += d / 2.0
            w[1:] += d / 2.0
        coeffs = w
    elif mref.kind == "expect":
        coeffs = np.full(len(supps), 1.0 / max(len(supps), 1))
    elif mref.kind == "support_sum":
        coeffs = np.ones(len(supps))
    else:
        raise ValueError(f"unknown measure kind {mref.kind!r}")
    if mref.weight_fn is not None:
        if g.scalar:
            wvals = np.asarray([mref.weight_fn(s) for s in supps])
        else:
            wvals = np.asarray([mref.weight_fn(*s) for s in supps])
        coeffs = coeffs * wvals
    return idxs, coeffs


def deriv(arg, pref, order=1):
    """Derivative operator (the reference's ∂/deriv).  Derivatives are
    deduplicated per (argument, parameter, order) by the model."""
    if not isinstance(pref, InfiniteParameter):
        raise TypeError("deriv expects a scalar infinite parameter")
    if not isinstance(arg, (InfiniteVar, DerivativeRef, SemiInfiniteVar)):
        raise TypeError(
            f"cannot differentiate {arg!r}; only infinite variables, "
            "derivatives, and semi-infinite variables are supported")
    if pref.group not in arg.groups:
        raise ValueError(f"{arg!r} does not depend on {pref!r}")
    if not pref.group.scalar:
        raise ValueError("derivatives w.r.t. dependent parameters are not "
                         "supported")
    if order < 1:
        raise ValueError("derivative order must be >= 1")
    model = arg.model
    return model._get_derivative(arg, pref, order)


def constant_over_collocation(var, pref):
    """Declare an infinite variable piecewise-constant over each collocation
    element (reference constant_over_collocation, transform.jl:565-601)."""
    if not isinstance(var, InfiniteVar):
        raise TypeError("constant_over_collocation expects an infinite "
                        "variable")
    g = pref.group
    if g not in var.groups:
        raise ValueError(f"{var!r} does not depend on {pref!r}")
    model = var.model
    model.piecewise_vars.setdefault(g.gid, []).append(var)
    model._mark_dirty()
