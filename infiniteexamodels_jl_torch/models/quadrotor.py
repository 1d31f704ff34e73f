"""Quadrotor trajectory-tracking OCP (reference ESCAPE34/quadrotor.jl):
9 states, 4 controls, trigonometric attitude dynamics, time-varying tracking
references as parameter functions, Lobatto orthogonal collocation."""
from __future__ import annotations

import math

from ..modeling import (
    InfiniteModel, OrthogonalCollocation, integral, deriv, sin, cos, tan,
    constant_over_collocation,
)


def quad(num_supports=100, backend=None, coll_nodes=3):
    n, p, T = 9, 4, 60.0
    m = InfiniteModel(backend)
    t = m.infinite_parameter(
        "t", domain=(0, T), num_supports=num_supports,
        derivative_method=OrthogonalCollocation(coll_nodes))

    d1 = m.parameter_function(
        lambda tv: math.sin(2 * math.pi * tv / T), (t,), name="d1")
    d3 = m.parameter_function(
        lambda tv: 2 * math.sin(4 * math.pi * tv / T), (t,), name="d3")
    d5 = m.parameter_function(lambda tv: 2 * (tv / T), (t,), name="d5")

    x = [m.variable(f"x{i}", deps=(t,)) for i in range(n)]
    u = [m.variable(f"u{i}", deps=(t,), start=0.0) for i in range(p)]

    m.minimize(integral(
        (x[0] - d1)**2 + (x[2] - d3)**2 + (x[4] - d5)**2
        + x[6]**2 + x[7]**2 + x[8]**2
        + 0.1 * (u[0]**2 + u[1]**2 + u[2]**2 + u[3]**2),
        t))

    for i in range(n):
        m.constraint(x[i](0) == 0)
    m.constraint(deriv(x[0], t) == x[1])
    m.constraint(deriv(x[1], t) ==
                 u[0] * cos(x[6]) * sin(x[7]) * cos(x[8])
                 + u[0] * sin(x[6]) * sin(x[8]))
    m.constraint(deriv(x[2], t) == x[3])
    m.constraint(deriv(x[3], t) ==
                 u[0] * cos(x[6]) * sin(x[7]) * sin(x[8])
                 - u[0] * sin(x[6]) * cos(x[8]))
    m.constraint(deriv(x[4], t) == x[5])
    m.constraint(deriv(x[5], t) == u[0] * cos(x[6]) * cos(x[7]) - 9.8)
    m.constraint(deriv(x[6], t) ==
                 u[1] * cos(x[6]) / cos(x[7]) + u[2] * sin(x[6]) / cos(x[7]))
    m.constraint(deriv(x[7], t) == -u[1] * sin(x[6]) + u[2] * cos(x[6]))
    m.constraint(deriv(x[8], t) ==
                 u[1] * cos(x[6]) * tan(x[7]) + u[2] * sin(x[6]) * tan(x[7])
                 + u[3])
    for ui in u:
        constant_over_collocation(ui, t)
    return m
