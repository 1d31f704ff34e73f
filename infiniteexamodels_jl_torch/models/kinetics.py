"""Chemical-kinetics optimal temperature control (reference
examples/kinetic_control.jl): stiff Arrhenius dynamics, maximize product
concentration at final time, high-order Lobatto collocation with
front-loaded supports."""
from __future__ import annotations

import math

from ..modeling import (
    InfiniteModel, OrthogonalCollocation, deriv, exp,
    constant_over_collocation,
)


def kinetic_control(num_supports=100, backend=None, coll_nodes=4):
    A = [3.6362e6, 2.5212e16, 190.6879, 8.7409e24]
    Ea = [10000.0, 25000.0, 5000.0, 40000.0]
    R = 1.987
    T_lower = 273.0 + 40
    T_upper = 273.0 + 60
    c0 = [1.0, 0.0, 0.0]
    Tr = [273.0 + v for v in (30, 40, 50, 70)]
    kr = [A[j] * math.exp(-Ea[j] / R / Tr[j]) for j in range(4)]
    tf = 3.0

    m = InfiniteModel(backend)
    t = m.infinite_parameter(
        "t", domain=(0, tf), num_supports=num_supports,
        derivative_method=OrthogonalCollocation(coll_nodes))
    m.add_supports(t, [0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.01, 0.1])
    c = [m.variable(f"c{i}", deps=(t,), lb=0, ub=1, start=c0[i])
         for i in range(3)]
    T = m.variable("T", deps=(t,), lb=T_lower, ub=T_upper, start=T_upper)
    m.maximize(c[1](tf))
    for i in range(3):
        m.constraint(c[i](0) == c0[i])
    # rates scaled relative to a reference temperature for conditioning
    k = [kr[j] * exp(Ea[j] / R * (1 / Tr[j] - 1 / T)) for j in range(4)]
    r1 = c[0] * k[0] - c[1] * k[1]
    r2 = c[0] * k[2] - c[2] * k[3]
    m.constraint(deriv(c[0], t) == -r1 - r2, name="b1")
    m.constraint(deriv(c[1], t) == r1)
    m.constraint(deriv(c[2], t) == r2)
    constant_over_collocation(T, t)
    return m
