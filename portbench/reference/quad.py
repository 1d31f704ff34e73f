"""The quadrotor tracking OCP of ESCAPE34/quadrotor.jl, transcribed by
Lobatto collocation as InfiniteOpt transcribes it, and the first-order
check of one answer.

The NLP, on the full grid of ``collocation.grid`` (``S`` points, ``E``
elements of ``n`` nodes), in the variables ``x`` (9 x S), ``u`` (4 x S)
and ``dx`` (9 x S), the derivative variables:

- minimize the trapezoid integral over the public supports of
  ``(x0 - d1)^2 + (x2 - d3)^2 + (x4 - d5)^2 + x6^2 + x7^2 + x8^2
  + 0.1 |u|^2``;
- ``x(0) = 0`` (9 rows);
- the collocation rows of ``collocation`` for each state (9 x E(n-1));
- the dynamics ``dx - F(x, u) = 0`` at every point (9 x S);
- each control constant over an element: at each interior node
  ``u(s_j) - u(s_{n-1}) = 0`` (4 x E(n-2)).

The answer gives ``x``, ``u``, ``dx`` and the duals of the user's rows
(the initial conditions and the dynamics).  The duals of the rows that
transcription adds (collocation, piecewise-constant controls) are not
queryable; they are worked out here from stationarity in ``u`` at the
interior nodes (exactly) and in ``x`` and ``dx`` (least squares over the
banded system), so the check asks whether multipliers exist that make
the answer a first-order point, with the reported ones for the user's
rows.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse
import torch

from . import collocation, kkt

STATES, CONTROLS, GRAVITY = 9, 4, 9.8


def tracking(spec, t, horizon):
    """One tracking reference at times ``t``: ``a sin(2 pi c t / T + phi)``
    or the ramp ``a t / T``."""
    if spec["form"] == "sin":
        return spec["amplitude"] * np.sin(
            2.0 * np.pi * spec["cycles"] * t / horizon + spec["phase"])
    if spec["form"] == "ramp":
        return spec["amplitude"] * t / horizon
    raise ValueError(f"unknown tracking form {spec['form']!r}")


def dynamics(x, u):
    """ESCAPE34/quadrotor.jl's right-hand side, rows 0..8."""
    c6, s6 = torch.cos(x[6]), torch.sin(x[6])
    c7, s7, t7 = torch.cos(x[7]), torch.sin(x[7]), torch.tan(x[7])
    c8, s8 = torch.cos(x[8]), torch.sin(x[8])
    return torch.stack([
        x[1],
        u[0] * c6 * s7 * c8 + u[0] * s6 * s8,
        x[3],
        u[0] * c6 * s7 * s8 - u[0] * s6 * c8,
        x[5],
        u[0] * c6 * c7 - GRAVITY,
        u[1] * c6 / c7 + u[2] * s6 / c7,
        -u[1] * s6 + u[2] * c6,
        u[1] * c6 * t7 + u[2] * s6 * t7 + u[3],
    ])


def _stack(d, names, size):
    rows = [np.asarray(d[k], dtype=np.float64).reshape(-1) for k in names]
    if any(r.shape != (size,) for r in rows):
        raise ValueError(f"answer rows {names} are not of length {size}")
    return torch.tensor(np.stack(rows), dtype=torch.float64,
                        requires_grad=True)


def _collocation_duals(g_x, g_dx, h, A, idx):
    """The collocation rows' duals ``lam`` (E(n-1) x 9) by least squares
    over every stationarity row they enter: in ``dx`` (``B lam = -g_dx``,
    ``B[idx[e, k], e (n-1) + j - 1] = h_e A[j - 1, k]``) and in ``x``
    (``C lam = g_x``, ``+1`` at ``idx[e, j]``, ``-1`` at ``idx[e, 0]``).
    The ``dx`` rows alone leave a slowly varying multiple of the pattern
    ``(-2, 1)`` per element all but free (for ``n = 3``; their condition
    grows with the number of elements); the ``x`` rows pin it.  The
    normal equations are banded with half-width ``2 (n - 1) - 1``.
    Returns ``lam``, ``B lam`` and ``C lam`` (points x states)."""
    E, n = idx.shape
    S = g_dx.shape[1]
    ncol = E * (n - 1)
    col = np.arange(E)[:, None] * (n - 1) + np.arange(n - 1)[None, :]
    cols = np.broadcast_to(col[:, :, None], (E, n - 1, n))
    rows = np.broadcast_to(idx[:, None, :], cols.shape)
    vals = h[:, None, None] * A[None, :, :]
    B = scipy.sparse.csr_matrix(
        (vals.reshape(-1), (rows.reshape(-1), cols.reshape(-1))),
        shape=(S, ncol))
    c_rows = np.concatenate([idx[:, 1:].reshape(-1),
                             np.repeat(idx[:, 0], n - 1)])
    c_cols = np.concatenate([col.reshape(-1), col.reshape(-1)])
    c_vals = np.concatenate([np.ones(ncol), -np.ones(ncol)])
    C = scipy.sparse.csr_matrix((c_vals, (c_rows, c_cols)), shape=(S, ncol))
    normal = (B.T @ B + C.T @ C).tocsr()
    bw = 2 * (n - 1) - 1
    ab = np.zeros((bw + 1, ncol))
    for d in range(bw + 1):
        ab[bw - d, d:] = normal.diagonal(d)
    lam = scipy.linalg.solveh_banded(ab, C.T @ g_x.T - B.T @ g_dx.T)
    return lam, B @ lam, C @ lam


def residuals(inputs, answer):
    """``primal_inf``, ``dual_inf`` and ``obj_rel`` of one answer."""
    N, T, n = (inputs["num_supports"], inputs["horizon"],
               inputs["collocation_nodes"])
    full, public = collocation.grid(N, T, n)
    S, E = len(full), N - 1
    vals, ders = answer["values"], answer["derivatives"]
    x = _stack(vals, [f"x{i}" for i in range(STATES)], S)
    u = _stack(vals, [f"u{k}" for k in range(CONTROLS)], S)
    dx = _stack(ders, [f"d(x{i},t)" for i in range(STATES)], S)

    tp = full[public]
    w = torch.tensor(collocation.trapezoid_weights(tp))
    ref = {k: torch.tensor(tracking(spec, tp, T))
           for k, spec in inputs["tracking"].items()}
    xp, up = x[:, public], u[:, public]
    f = (w * ((xp[0] - ref["d1"]) ** 2 + (xp[2] - ref["d3"]) ** 2
              + (xp[4] - ref["d5"]) ** 2 + xp[6] ** 2 + xp[7] ** 2
              + xp[8] ** 2 + 0.1 * (up ** 2).sum(0))).sum()

    A = collocation.integration_matrix(n)
    h = np.diff(tp)
    idx = np.arange(E)[:, None] * (n - 1) + np.arange(n)[None, :]
    xe, dxe = x[:, idx], dx[:, idx]
    coll = (xe[:, :, 1:] - xe[:, :, :1]
            - torch.tensor(h)[None, :, None]
            * torch.einsum("jk,iek->iej", torch.tensor(A), dxe))
    dyn = dx - dynamics(x, u)
    init = x[:, 0]
    coc = u[:, idx[:, 1:-1]] - u[:, idx[:, -1:]]

    primal_inf = max(float(c.detach().abs().max()) if c.numel() else 0.0
                     for c in (init, coll, dyn, coc))

    duals = answer["duals"]
    lam_init = torch.tensor([float(duals[i]) for i in range(STATES)])
    lam_dyn = _stack({i: duals[STATES + i] for i in range(STATES)},
                     list(range(STATES)), S).detach()
    lag = f - (lam_init * init).sum() - (lam_dyn * dyn).sum()
    g_x, g_u, g_dx = (g.detach().numpy().copy()
                      for g in torch.autograd.grad(lag, [x, u, dx]))

    # controls: each interior node's row takes its own stationarity
    lam_coc = g_u[:, idx[:, 1:-1]]
    g_u[:, idx[:, 1:-1]] = 0.0
    g_u[:, idx[:, -1]] += lam_coc.sum(-1)
    # collocation rows: least squares over the x and dx rows
    lam_coll, b_lam, c_lam = _collocation_duals(g_x, g_dx, h, A, idx)
    g_dx = g_dx + b_lam.T
    g_x = g_x - c_lam.T

    nrow = init.numel() + coll.numel() + dyn.numel() + coc.numel()
    s_d = kkt.dual_scale([lam_init.numpy(), lam_dyn.numpy(), lam_coc,
                          lam_coll], nrow + (2 * STATES + CONTROLS) * S)
    dual_inf = max(np.abs(g).max() for g in (g_x, g_u, g_dx)) / s_d
    return {"primal_inf": primal_inf, "dual_inf": float(dual_inf),
            "obj_rel": kkt.relative_gap(answer["objective"],
                                        float(f.detach()))}
