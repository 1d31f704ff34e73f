"""Three-node stochastic flexibility design (reference
examples/3node_design.jl): maximize the probability-like expectation of
constraint satisfaction over MvNormal demand, big-M indicator relaxation."""
from __future__ import annotations

import numpy as np

from ..modeling import InfiniteModel, mvnormal, expect


def design_3node(num_scenarios=1000, backend=None, seed=42):
    theta_nom = np.array([0.0, 60.0, 10.0])
    covar = np.diag([80.0, 80.0, 120.0])
    n_z = n_th = n_d = 3
    c = np.ones(n_d) / np.sqrt(n_d)
    c_max = 5.0
    U = 10000.0

    m = InfiniteModel(backend, seed=seed)
    th = m.infinite_parameter("theta", dist=mvnormal(theta_nom, covar),
                              num_supports=num_scenarios)
    y = m.variable("y", deps=(th,), lb=0, ub=1)
    z = [m.variable(f"z{i}", deps=(th,)) for i in range(n_z)]
    d = [m.variable(f"d{i}", lb=0) for i in range(n_d)]
    m.maximize(expect(1 - y, th))
    m.constraint(-z[0] - 35 - d[0] <= y * U, name="f1")
    m.constraint(z[0] - 35 - d[0] <= y * U, name="f2")
    m.constraint(-z[1] - 50 - d[1] <= y * U, name="f3")
    m.constraint(z[0] - 50 - d[1] <= y * U, name="f4")
    m.constraint(-z[2] <= y * U, name="f5")
    m.constraint(z[2] - 100 - d[2] <= y * U, name="f6")
    m.constraint(z[0] - th[0] == 0, name="h1")
    m.constraint(-z[0] - z[1] + z[2] - th[1] == 0, name="h2")
    m.constraint(z[1] - th[2] == 0, name="h3")
    m.constraint(sum(c[i] * d[i] for i in range(n_d)) <= c_max,
                 name="max_cost")
    return m
