"""SEIR pandemic control under parametric uncertainty (reference
ESCAPE34/pandemic.jl): time x scenario product grid, uncertain incubation
rate xi ~ Uniform, shared control u(t), infection-cap path constraint."""
from __future__ import annotations

import numpy as np

from ..modeling import (InfiniteModel, uniform, integral, expect,
                        support_sum, deriv)

_GAMMA, _BETA, _N = 0.303, 0.727, 1e5


def _seir_f(x, u, xi):
    """SEIR vector field; x is (..., 4) = (s, e, i, r)."""
    s, e, i = x[..., 0], x[..., 1], x[..., 2]
    inf = (1.0 - u) * _BETA * s * i
    return np.stack([-inf, inf - xi * e, xi * e - _GAMMA * i, _GAMMA * i],
                    axis=-1)


def seir_rollout(ts, xis, u_traj):
    """Backward-Euler rollout of the SEIR dynamics on the (sorted) support
    grid per scenario -- the SAME implicit scheme the default
    FiniteDifference(Backward) transcription imposes, so the result is a
    feasible point of the discretized dynamics (up to Newton tolerance).

    Returns ``(states, dstates)`` with shapes (nt, nxi, 4): the state
    trajectories and the implicit derivative values f(x_k, u_k).
    """
    ts = np.asarray(ts, float)
    xis = np.asarray(xis, float)
    u_traj = np.asarray(u_traj, float)
    nt, nx = len(ts), len(xis)
    X = np.zeros((nt, nx, 4))
    X[0, :, 0] = 1.0 - 1.0 / _N
    X[0, :, 1] = 1.0 / _N
    eye = np.eye(4)
    for k in range(1, nt):
        h = ts[k] - ts[k - 1]
        uk = u_traj[k]
        x = X[k - 1].copy()
        # Newton on g(x) = x - x_prev - h f(x): the 4x4 Jacobian is
        # closed-form; 6 iterations are ample at these step sizes
        for _ in range(6):
            g = x - X[k - 1] - h * _seir_f(x, uk, xis)
            s, e, i = x[:, 0], x[:, 1], x[:, 2]
            b = (1.0 - uk) * _BETA
            A = np.zeros((nx, 4, 4))
            A[:, 0, 0] = -b * i
            A[:, 0, 2] = -b * s
            A[:, 1, 0] = b * i
            A[:, 1, 1] = -xis
            A[:, 1, 2] = b * s
            A[:, 2, 1] = xis
            A[:, 2, 2] = -_GAMMA
            A[:, 3, 2] = _GAMMA
            J = eye[None] - h * A
            x = x - np.linalg.solve(J, g[..., None])[..., 0]
        X[k] = x
    dX = _seir_f(X, u_traj[:, None], xis[None, :])
    return X, dX


def pandemic(seed=0, num_supports=100, num_scenarios=4, backend=None,
             dmethod=None, u_start=None, elastic_rho=None,
             elastic_penalty="support_sum"):
    """SEIR control model.  ``u_start`` engages a dynamics-feasible
    warmstart: a scalar, callable u(t), or per-support array of control
    values; the states (and derivative variables) start from the
    backward-Euler rollout under that control.  Passing a coarse-scenario
    solve's optimal control helps the larger grids but does not certify
    the (100,128) reference config: its 128 coupled singular arcs still
    crawl.

    ``elastic_rho`` engages the L1-elastic reformulation of the
    infection-cap path constraint: ``i <= 0.02`` becomes
    ``i - v <= 0.02`` with a slack ``v(t, xi) >= 0`` penalized in the
    objective.  The cap constraint is a high-order state constraint whose
    discretization violates LICQ on the singular arc (unbounded multiplier
    ray -- the reference's large pandemic configs,
    run_cases_cpu.jl:108-110, inherit the same geometry); each elastic
    row's multiplier is bounded by construction through v's stationarity
    (0 <= lambda_k <= per-point penalty weight), so the IPM dual endgame
    cannot ride the ray.  ``elastic_penalty`` picks the weight geometry:
    "support_sum" (default) charges ``rho`` per support point, making the
    multiplier cap exactly ``rho`` and independent of grid size or
    scenario count; "expect_integral" charges
    ``rho * E_xi[integral(v, t)]`` (caps scale as rho*w_k/n_xi -- the
    measure-consistent form, but the cap shrinks with scenario count).
    An exact-penalty rho (above the minimal multiplier norm) recovers the
    original solution; on the degenerate arc it yields the L1-closest
    relaxation."""
    gamma, beta, N = _GAMMA, _BETA, _N
    extra_ts = [0.001, 0.002, 0.004, 0.008, 0.02, 0.04, 0.08, 0.2, 0.4, 0.8]

    m = InfiniteModel(backend, seed=seed)
    kwargs = {}
    if dmethod is not None:
        kwargs["derivative_method"] = dmethod
    t = m.infinite_parameter("t", domain=(0, 200), num_supports=num_supports,
                             **kwargs)
    xi = m.infinite_parameter("xi", dist=uniform(0.1, 0.6),
                              num_supports=num_scenarios)
    m.add_supports(t, extra_ts)
    s = m.variable("s", deps=(t, xi), lb=0)
    e = m.variable("e", deps=(t, xi), lb=0)
    i = m.variable("i", deps=(t, xi), lb=0)
    r = m.variable("r", deps=(t, xi), lb=0)
    u = m.variable("u", deps=(t,), lb=0, ub=0.8, start=0.2)
    if elastic_rho is not None:
        v = m.variable("v_imax", deps=(t, xi), lb=0, start=0.0)
        if elastic_penalty == "support_sum":
            pen = elastic_rho * support_sum(support_sum(v, t), xi)
        elif elastic_penalty == "expect_integral":
            pen = elastic_rho * expect(integral(v, t), xi)
        else:
            raise ValueError(f"unknown elastic_penalty {elastic_penalty!r}")
        m.minimize(integral(u, t) + pen)
    else:
        m.minimize(integral(u, t))
    m.constraint(s(0, xi) == 1 - 1 / N)
    m.constraint(e(0, xi) == 1 / N)
    m.constraint(i(0, xi) == 0)
    m.constraint(r(0, xi) == 0)
    m.constraint(deriv(s, t) == -(1 - u) * beta * s * i, name="s_constr")
    m.constraint(deriv(e, t) == (1 - u) * beta * s * i - xi * e,
                 name="e_constr")
    m.constraint(deriv(i, t) == xi * e - gamma * i, name="i_constr")
    m.constraint(deriv(r, t) == gamma * i, name="r_constr")
    if elastic_rho is not None:
        m.constraint(i - v <= 0.02, name="imax_constr")
    else:
        m.constraint(i <= 0.02, name="imax_constr")

    if u_start is not None:
        ts = np.asarray(t.group.supports(), float)
        xis = np.asarray(xi.group.supports(), float).reshape(-1)
        order = np.argsort(ts, kind="stable")
        inv = np.argsort(order, kind="stable")
        if callable(u_start):
            uu = np.array([float(u_start(tv)) for tv in ts])
        else:
            uu = np.broadcast_to(np.asarray(u_start, float),
                                 ts.shape).copy()
        uu = np.clip(uu, 0.0, 0.8)
        X, dX = seir_rollout(ts[order], xis, uu[order])
        X, dX = X[inv], dX[inv]          # back to support storage order
        u.info.start = uu
        for k, vref in enumerate((s, e, i, r)):
            vref.info.start = X[:, :, k]
        # derivative variables (created by the constraints above) start at
        # the implicit derivative values so the defining FD equations hold
        by_arg = {id(d.argument): d for d in m._derivs}
        for k, vref in enumerate((s, e, i, r)):
            d = by_arg.get(id(vref))
            if d is not None:
                d.info.start = dX[:, :, k]
    return m
