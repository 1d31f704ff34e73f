"""Farmer two-stage stochastic program (reference examples/2stage_example.jl):
land allocation under yield uncertainty, 1000 scenarios, expectation
objective with first-stage coupling."""
from __future__ import annotations

from ..modeling import InfiniteModel, uniform, expect


def farmer(num_scenarios=1000, backend=None, seed=42):
    alpha = [150.0, 230.0, 260.0]   # land cost
    beta = [238.0, 210.0, 0.0]      # purchasing cost
    lam = [170.0, 150.0, 36.0]      # selling price
    d = [200.0, 240.0, 0.0]         # contract demand
    xbar = 500.0                    # total land
    wbar3 = 6000.0
    ybar3 = 0.0
    dists = [uniform(0, 5), uniform(0, 5), uniform(10, 30)]

    m = InfiniteModel(backend, seed=seed)
    xi = m.infinite_parameter("xi", dist=dists, num_supports=num_scenarios)
    x = [m.variable(f"x{c}", lb=0, ub=xbar) for c in range(3)]
    y = [m.variable(f"y{c}", deps=(xi,), lb=0) for c in range(3)]
    w = [m.variable(f"w{c}", deps=(xi,), lb=0) for c in range(3)]
    first_stage = sum(alpha[c] * x[c] for c in range(3))
    recourse = sum(beta[c] * y[c] - lam[c] * w[c] for c in range(3))
    m.minimize(first_stage + expect(recourse, xi))
    m.constraint(x[0] + x[1] + x[2] <= xbar)
    for c in range(3):
        m.constraint(xi[c] * x[c] + y[c] - w[c] >= d[c])
    m.constraint(w[2] <= wbar3)
    m.constraint(y[2] <= ybar3)
    return m
