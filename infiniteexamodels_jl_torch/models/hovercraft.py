"""Hovercraft waypoint trajectory OCP (reference
examples/hovercraft_example.jl): 2-D double integrator hitting waypoints at
fixed times, minimum control effort, backward finite differences."""
from __future__ import annotations

import numpy as np

from ..modeling import InfiniteModel, FiniteDifference, Backward, integral, deriv


def hovercraft(num_supports=101, backend=None, dmethod=None):
    xw = np.array([[1.0, 4.0, 6.0, 1.0], [1.0, 3.0, 0.0, 1.0]])  # positions
    tw = np.array([0.0, 25.0, 50.0, 60.0])                        # times

    m = InfiniteModel(backend)
    t = m.infinite_parameter(
        "t", domain=(0, 60), num_supports=num_supports,
        derivative_method=dmethod or FiniteDifference(Backward()))
    x = [m.variable(f"x{i}", deps=(t,)) for i in range(2)]
    v = [m.variable(f"v{i}", deps=(t,)) for i in range(2)]
    u = [m.variable(f"u{i}", deps=(t,), start=0.0) for i in range(2)]
    m.minimize(integral(u[0]**2 + u[1]**2, t))
    for i in range(2):
        m.constraint(v[i](0) == 0)
        m.constraint(deriv(x[i], t) == v[i])
        m.constraint(deriv(v[i], t) == u[i])
        for j in range(len(tw)):
            m.constraint(x[i](tw[j]) == xw[i, j])
    return m
