"""Filter line-search interior-point method on the condensed KKT.

A PyTorch implementation of the algorithm family the reference delegates
to Ipopt (CPU) and MadNLP (GPU) (reference ext/ glue:
InfiniteExaModels.jl/ext/InfiniteExaModelsIpopt.jl:42-61,
InfiniteExaModels.jl/ext/InfiniteExaModelsMadNLP.jl:43-65).  Design follows
the condensed-space GPU IPM literature (PAPERS.md): all inequality
constraints are slacked, equalities are lifted with a tiny bound
relaxation, and each Newton step reduces to one SPD "condensed" system in x
factorized on the device.

Algorithm skeleton (Waechter-Biegler filter line search, monotone barrier):

  - gradient-based objective/constraint scaling at x0 (gmax = 100)
  - primal-dual Newton steps from the condensed system
    K = W + Sigma_x + delta_w + J^T D J
  - inertia-free regularization: Cholesky retry with delta_w bumping
  - fraction-to-boundary + filter backtracking line search, second-order
    correction, feasibility restoration on repeated line-search failure
  - Fiacco-McCormick barrier decrease, acceptable-point termination

Tensors stay on the model's device; the iteration is an eager host loop
(one ``_step`` per iteration, each inner loop a Python loop that reads its
condition back from the device).  The host-side decisions that the
reference takes once per device chunk of 32 iterations (the least-squares
dual recalc triggers, the low-precision step sets' handover to f64, the
checkpoints) are taken at the same iterations here.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..utils.timers import Recorder, count, phases, span
from .kkt import DenseKKT
from .results import ExecutionStats

# status codes
RUNNING, FIRST_ORDER, ACCEPTABLE, INFEASIBLE, STALLED, DIVERGED, INVALID = \
    0, 1, 2, 3, 4, 5, 6
NEED_RESTORATION = 7     # host-visible: enter the feasibility restoration
                         # phase, then resume (never escapes to the user)
DEMOTE_F32 = 8           # host-visible: the f32 factorization can no longer
                         # deliver refinable steps; the host hands the
                         # unchanged state to the f64 step set (never
                         # escapes to the user)

_STATUS_NAMES = {
    FIRST_ORDER: "first_order",
    ACCEPTABLE: "acceptable",
    INFEASIBLE: "infeasible",
    STALLED: "stalled",
    DIVERGED: "unbounded",
    INVALID: "invalid_number",
}

FILTER_SIZE = 128
TRACE_FILE = "ipm_solve.pt.trace.json"   # solve(trace_dir=...) writes it
# iterations per host round-trip of the reference's non-verbose loop: the
# recalc triggers are evaluated at the iterations where it returns to the
# host, so the two trajectories agree
HOST_CHUNK = 32
# counters every solve's result carries, at 0 where nothing happened: the
# second-order corrections tried, and the rounds of the condensed solve's
# iterative refinement (each a solve and a matvec, or in ir32 a PCG step)
ZEROED_COUNTS = ("ipm.soc_trials", "kkt.refine_rounds")


class IpmState(NamedTuple):
    x: torch.Tensor          # (n,)
    s: torch.Tensor          # (m,)
    y: torch.Tensor          # (m,)
    zl: torch.Tensor         # (n+m,)
    zu: torch.Tensor         # (n+m,)
    # bounds are STATE: tiny-slack correction moves them outward by machine-
    # level amounts when a lifted equality pins its slack (Ipopt's
    # slack-correction mechanism); initialized from the relaxed bounds
    lz: torch.Tensor         # (n+m,)
    uz: torch.Tensor         # (n+m,)
    mu: torch.Tensor
    tau: torch.Tensor
    delta_w_last: torch.Tensor
    # consecutive iterations where the delta_w = 0 first attempt was probed
    # and FAILED: drives the sticky-regularization policy
    zero_fail_streak: torch.Tensor
    filter_theta: torch.Tensor   # (FILTER_SIZE,)
    filter_phi: torch.Tensor
    filter_len: torch.Tensor
    iter: torch.Tensor
    status: torch.Tensor
    acceptable_count: torch.Tensor
    small_step_count: torch.Tensor
    ls_fail_count: torch.Tensor
    # best-iterate tracker + cumulative count of near-optimal VISITS
    # (degenerate-endgame limit-cycle escape; see _step)
    acc_visits: torch.Tensor
    best_E: torch.Tensor
    best_inf_pr: torch.Tensor
    best_inf_du: torch.Tensor
    # objective (scaled, minimization sense) at the stored best iterate,
    # and the lowest objective seen at any feasible-ish iterate
    best_fobj: torch.Tensor
    feas_fobj: torch.Tensor
    best_x: torch.Tensor
    best_s: torch.Tensor
    best_y: torch.Tensor
    best_zl: torch.Tensor
    best_zu: torch.Tensor
    # logging scalars from the last step
    log_obj: torch.Tensor
    log_inf_pr: torch.Tensor
    log_inf_du: torch.Tensor
    log_alpha: torch.Tensor
    log_alpha_z: torch.Tensor
    log_ls: torch.Tensor
    log_delta_w: torch.Tensor
    # relative residual of the condensed solve after iterative refinement
    log_rr: torch.Tensor
    # scaled overall KKT error at the step's start (the convergence E)
    log_E0: torch.Tensor


DEFAULTS = dict(
    tol=1e-8,
    acceptable_tol=1e-6,
    acceptable_iter=15,
    acceptable_constr_viol_tol=1e-2,
    acceptable_dual_inf_tol=1e10,
    acceptable_compl_inf_tol=1e-2,
    max_iter=3000,
    mu_init="auto",   # "auto": 0.1*max(1, theta0), clipped to [0.1, 100]
    s_max=100.0,
    kappa_epsilon=10.0,
    kappa_mu=0.2,
    theta_mu=1.5,
    barrier="monotone",     # or "adaptive": LOQO centrality-clipped mu
    tau_min=0.99,
    gamma_theta=1e-5,
    gamma_phi=1e-5,
    delta=1.0,
    s_theta=1.1,
    s_phi=2.3,
    eta_phi=1e-4,
    kappa_sigma=1e10,
    kappa_relax=1e-8,       # equality-lifting relaxation (LiftedKKT style)
    bound_push=1e-2,        # kappa_1/kappa_2
    bound_frac=1e-2,
    delta_w_init=1e-4,
    delta_w_min=1e-20,
    delta_w_max=1e40,        # accepted and, as in the reference, unused
    kappa_w_plus_init=100.0,
    kappa_w_plus=8.0,
    kappa_w_minus=1.0 / 3.0,
    delta_c_bar=1e-8,
    delta_c_mu_floor=0.0,    # optional mu floor inside the delta_c schedule
    # dual-ray proximal damping: while the ray signature is live (some
    # |y| beyond ray_y_cap, primal converged, capped dual error far from
    # stationary) the constraint rows pull the multiplier excess beyond
    # the cap toward zero with weight ray_delta
    ray_damping=False,
    ray_delta=1e-8,
    ray_y_cap=1e4,
    # mu-scaled dual-step damping kappa*mu, engaged once
    # mu <= prox_dual_mu_max (0 = off)
    prox_dual_kappa=0.0,
    prox_dual_mu_max=1e-3,
    # least-squares dual recalc (Ipopt recalc_y role) when max |y| passes
    # recalc_y_cap ...
    recalc_y=False,
    recalc_y_cap=1e3,
    # ... or on the feasible-but-dual-stalled crawl (pr <= 1e2*tol,
    # du > 1e4*tol, alpha <= 0.25), optionally only once the objective has
    # stopped decreasing; checked every HOST_CHUNK iterations
    recalc_y_stall=False,
    recalc_y_obj_gate=False,
    max_backtracks=40,
    soc=True,                # second-order correction (Ipopt A-5.7..5.9)
    refine_max=10,           # iterative-refinement round cap
    refine_tol=1e-9,         # stop refining below this relative residual
    # acceptance (step rejected above it); None resolves to 1e-6, the value
    # for hosts with native f64 (CPU and CUDA)
    refine_accept=None,
    # f32 step sets ("mixed", "float32"): the refinement reference is the
    # f32-assembled K (a ~1e-7-relative model), so the loop is capped
    # tighter and a miss demotes to f64 instead of bumping delta_w
    refine_max_f32=4,
    refine_tol_f32=1e-6,
    refine_accept_f32=1e-4,
    # "ir32": the refinement reference is the exact f64 operator, so the
    # loop (f32-preconditioned CG) runs many rounds at a loose contraction
    # rate and accepts anything at least as good as a pure-f32 step
    refine_max_ir=25,
    refine_contract=0.3,     # stop refining when rate exceeds this
    refine_contract_ir=0.95,
    # ir32 acceptance clamp(factor*mu, refine_accept_f32, 1e-2) and target
    # clamp(0.05*factor*mu, refine_tol, refine_tol_cap_ir): both tighten
    # with the barrier parameter
    refine_mu_factor_ir=100.0,
    refine_tol_cap_ir=1e-6,
    # degenerate-endgame limit-cycle escape (see _step)
    acceptable_visit_tol_factor=1e3,
    acceptable_visit_limit=25,
    # objective sanity guard on the best-iterate tracker
    restore_obj_guard=0.1,
    # sticky regularization: after this many CONSECUTIVE failures of the
    # delta_w = 0 first attempt, start the ladder at the warm value
    # max(delta_w_min, kappa_w_minus * delta_w_last); every
    # reg_zero_reprobe-th iteration probes zero regardless
    reg_zero_skip_streak=3,
    reg_zero_reprobe=3,
    max_reg_tries=30,
    y_reset_cap=1e3,
    kappa_d=1e-5,
    max_ls_failures=4,
    nlp_scaling_max_gradient=100.0,
    print_level=5,
    max_wall_time=1e20,
    mu_min_fraction=0.1,     # mu floor = tol * this
    # "float64": f64 throughout.  "float32": assembly and factorization
    # in f32 until a refinement failure demotes to the f64 step set.
    # "mixed": like "float32" while mu > mu_switch_f32, then f64.  "ir32":
    # f32 assembly and factorization refined against the exact f64
    # operator, handing over at mu_switch_ir (0: only on demotion).  The
    # f32 sets need the structured KKT; on the dense one they run in f64.
    factor_dtype="float64",
    mu_switch_f32=1e-4,
    mu_switch_ir=0.0,
    # "dense" | "block_tridiag" | "auto" | "ldl_cpp" (alias "ma27": the
    # host sparse LDL, the role MA27 plays under Ipopt in the reference)
    linear_solver="dense",
    # feasibility restoration (Ipopt §3.3 role): Levenberg-Marquardt
    # Gauss-Newton descent on the (proximally damped) constraint violation,
    # reusing the condensed-KKT machinery
    restoration=True,
    resto_max_iter=30,
    resto_max_entries=5,     # restoration rounds before giving up (stalled)
    resto_zeta=1e-6,         # proximal weight on ||x - x_entry||_{D_R}
    resto_delta_init=1e-8,   # initial LM damping
    # "zero" starts y at the user/warm-start value; "lsq" at the
    # least-squares stationarity fit (Ipopt least_square_init_duals role)
    dual_init="zero",
)

def _amax0(a):
    """max(a) with initial 0 (NaN propagates)."""
    if a.numel() == 0:
        return a.new_zeros(())
    return torch.clamp(a.max(), min=0.0)


def _amin_inf(a):
    """min(a) with initial +inf."""
    if a.numel() == 0:
        return a.new_full((), float("inf"))
    return torch.clamp(a.min(), max=float("inf"))


def _amax(a):
    return a.max() if a.numel() else a.new_zeros(())


def _i32(v, device):
    return torch.as_tensor(v, dtype=torch.int32, device=device)


def _read(t, to=bool):
    """``to(t)`` of a device value: on the card the host waits there for
    the queue, and the span times that wait."""
    with span("ipm.host_sync"):
        return to(t)


class IpmSolver:
    """Interior-point solver over a :class:`SimdModel`.

    ``IpmSolver(model, **options)`` then ``solve()``; ``reset(model)`` +
    ``solve()`` re-solves (the reference's SolverCore.reset!/resolve
    pattern, ext/InfiniteExaModelsIpopt.jl:53-61).
    """

    def __init__(self, model, kkt=None, **options):
        self.model = model
        self.opts = dict(DEFAULTS)
        self.set_options(**options)
        if self.opts["refine_accept"] is None:
            self.opts["refine_accept"] = 1e-6
        if kkt is None:
            kind = self.opts["linear_solver"]
            if kind == "dense":
                kkt = DenseKKT(model)
            elif kind in ("block_tridiag", "auto"):
                from .block_tridiag import make_structured_kkt

                kkt = make_structured_kkt(model, fallback=(kind == "auto"))
            elif kind in ("ldl_cpp", "ma27"):
                from .cpp_ldl import CppLdlKKT

                kkt = CppLdlKKT(model)
            else:
                raise ValueError(f"unknown linear_solver {kind!r}")
        self.kkt = kkt
        self.kkt32 = self._low_precision_view()
        self._consts_cache = None
        self.results = None
        self.host_returns = []   # iterations of the last solve's host returns

    def set_options(self, **options):
        for k, v in options.items():
            if k not in DEFAULTS:
                raise ValueError(f"unknown IPM option {k!r}")
            self.opts[k] = v
        if "factor_dtype" in options and hasattr(self, "kkt"):
            self.kkt32 = self._low_precision_view()

    def _low_precision_view(self):
        """The low-precision step sets' view of the KKT, which assembles
        and factors in f32, or None (the f64 step set, or a backend without
        one, such as the dense one and the host LDL, where every step set
        runs in f64, as in the reference).  The f64 view stays for the
        handover."""
        if self.opts["factor_dtype"] not in ("mixed", "float32", "ir32"):
            return None
        return self.kkt.low_precision_view()

    def reset(self, model=None):
        """Prepare for a re-solve; model shape must be unchanged."""
        if model is not None and model is not self.model:
            if (model.nvar != self.model.nvar
                    or model.ncon != self.model.ncon):
                raise ValueError("reset with a different-shaped model")
            self.model = model
        return self

    # ------------------------------------------------------------------
    # problem-constant data for one solve
    # ------------------------------------------------------------------
    def _make_consts(self, theta, x0=None, lvar=None, uvar=None):
        m = self.model
        o = self.opts
        dt = m.dtype
        dev = m.device
        x0 = m.x0 if x0 is None else x0
        lvar = m.lvar if lvar is None else lvar
        uvar = m.uvar if uvar is None else uvar
        # gradient-based scaling at x0 (Ipopt nlp_scaling_method=gradient-based)
        gmax = o["nlp_scaling_max_gradient"]
        g0 = m.grad(x0, theta) * m.sense
        sf = torch.clamp(gmax / torch.clamp(_amax(torch.abs(g0)), min=1e-8),
                         max=1.0)
        jv0 = m.jac_vals(x0, theta)
        # per-constraint-row max |J|
        rowmax = m.jac_row_absmax(jv0)
        sc = torch.clamp(gmax / torch.clamp(rowmax, min=1e-8), max=1.0)

        lcon = m.lcon * sc
        ucon = m.ucon * sc
        lz = torch.cat([lvar, lcon])
        uz = torch.cat([uvar, ucon])
        # Ipopt-style bound_relax_factor: every finite bound is relaxed
        # outward by kr*max(1,|b|).  This both lifts equalities/fixed
        # variables (LiftedKKT-style, so the condensed system stays regular)
        # and reproduces the solver-reported objectives of the reference
        # oracle values, which embed exactly this perturbation.
        kr = o["kappa_relax"]
        lz = torch.where(torch.isfinite(lz),
                         lz - kr * torch.clamp(torch.abs(lz), min=1.0), lz)
        uz = torch.where(torch.isfinite(uz),
                         uz + kr * torch.clamp(torch.abs(uz), min=1.0), uz)
        has_l = torch.isfinite(lz)
        has_u = torch.isfinite(uz)
        return dict(
            theta=theta, sf=sf, sc=sc, lz=lz, uz=uz,
            has_l=has_l, has_u=has_u,
            tol=torch.as_tensor(o["tol"], dtype=dt, device=dev),
            acceptable_tol=torch.as_tensor(o["acceptable_tol"], dtype=dt,
                                           device=dev),
            acceptable_iter=_i32(o["acceptable_iter"], dev),
            mu_init=torch.as_tensor(
                -1.0 if o["mu_init"] == "auto" else o["mu_init"], dtype=dt,
                device=dev),
        )

    def _compute_consts(self, theta, m):
        """Problem constants, cached across solves on a content fingerprint
        of (theta, x0, bounds) plus the options that feed them."""
        o = self.opts
        key = (m.consts_fingerprint(), o["nlp_scaling_max_gradient"],
               o["kappa_relax"], o["tol"], o["acceptable_tol"],
               o["acceptable_iter"], o["mu_init"])
        cached = self._consts_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        out = self._make_consts(theta, m.x0, m.lvar, m.uvar)
        self._consts_cache = (key, out)
        return out

    # -- scaled model evaluations ---------------------------------------
    def _feval(self, x, c):
        return self.model.obj(x, c["theta"]) * self.model.sense * c["sf"]

    def _geval(self, x, c):
        return self.model.grad(x, c["theta"]) * self.model.sense * c["sf"]

    def _ceval(self, x, c):
        return self.model.cons(x, c["theta"]) * c["sc"]

    def _jvals(self, x, c):
        return self.model.jac_vals(x, c["theta"]) * c["sc"][self.model.jac_rows]

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def _init_state(self, x0, y0, consts, zl0=None, zu0=None):
        m = self.model
        o = self.opts
        dt = m.dtype
        dev = m.device
        n = m.nvar
        lz, uz = consts["lz"], consts["uz"]
        has_l, has_u = consts["has_l"], consts["has_u"]
        k1, k2 = o["bound_push"], o["bound_frac"]

        def push_inside(z, lo, hi, hl, hu):
            both = hl & hu
            span = torch.where(both, hi - lo, 1.0)
            pl = torch.where(
                both,
                torch.minimum(k1 * torch.clamp(torch.abs(lo), min=1.0),
                              k2 * span),
                k1 * torch.clamp(torch.abs(lo), min=1.0))
            pu = torch.where(
                both,
                torch.minimum(k1 * torch.clamp(torch.abs(hi), min=1.0),
                              k2 * span),
                k1 * torch.clamp(torch.abs(hi), min=1.0))
            z = torch.where(hl, torch.maximum(z, lo + pl), z)
            z = torch.where(hu, torch.minimum(z, hi - pu), z)
            return z

        x = push_inside(x0, lz[:n], uz[:n], has_l[:n], has_u[:n])
        c0 = self._ceval(x, consts)
        s = push_inside(c0, lz[n:], uz[n:], has_l[n:], has_u[n:])
        # warm bound duals (Ipopt warm_start_init_point role): clipped to
        # a strictly interior band so complementarity products stay sane
        if zl0 is None:
            zl = has_l.to(dt)
        else:
            zl = torch.where(has_l, torch.clamp(zl0.to(dt), 1e-8, 1e10), 0.0)
        if zu0 is None:
            zu = has_u.to(dt)
        else:
            zu = torch.where(has_u, torch.clamp(zu0.to(dt), 1e-8, 1e10), 0.0)
        theta0 = torch.sum(torch.abs(c0 - s))
        # scale-aware automatic initial barrier (MAX-norm keeps the
        # heuristic size-independent)
        theta_inf = _amax0(torch.abs(c0 - s))
        mu_auto = torch.clamp(0.1 * torch.clamp(theta_inf, min=1.0),
                              0.1, 100.0)
        mu = torch.where(consts["mu_init"] < 0, mu_auto, consts["mu_init"])
        theta_max = 1e4 * torch.clamp(theta0, min=1.0)
        ft = torch.full((FILTER_SIZE,), float("inf"), dtype=dt, device=dev)
        ft[0] = theta_max
        fp = torch.full((FILTER_SIZE,), -float("inf"), dtype=dt, device=dev)
        zero = torch.zeros((), dtype=dt, device=dev)
        inf = torch.full((), float("inf"), dtype=dt, device=dev)
        i0 = _i32(0, dev)
        return IpmState(
            x=x, s=s, y=y0, zl=zl, zu=zu, lz=lz, uz=uz, mu=mu,
            tau=torch.clamp(1.0 - mu, min=o["tau_min"]),
            delta_w_last=zero,
            zero_fail_streak=i0,
            filter_theta=ft, filter_phi=fp,
            filter_len=_i32(1, dev),
            iter=i0,
            status=_i32(RUNNING, dev),
            acceptable_count=i0,
            small_step_count=i0,
            ls_fail_count=i0,
            acc_visits=i0,
            best_E=inf, best_inf_pr=inf, best_inf_du=inf,
            best_fobj=inf, feas_fobj=inf,
            best_x=x, best_s=s, best_y=y0, best_zl=zl, best_zu=zu,
            log_obj=zero, log_inf_pr=theta0,
            log_inf_du=zero,
            log_alpha=zero, log_alpha_z=zero,
            log_ls=i0, log_delta_w=zero,
            log_rr=zero,
            log_E0=inf,
        )

    # ------------------------------------------------------------------
    # residuals
    # ------------------------------------------------------------------
    def _kkt_error(self, st, consts, grad, jvals, cval, mu):
        """(E, inf_pr, inf_du, inf_comp, s_d, s_c) with Ipopt's scalings."""
        m = self.model
        o = self.opts
        z = torch.cat([st.x, st.s])
        lz, uz = st.lz, st.uz
        has_l, has_u = consts["has_l"], consts["has_u"]
        jty = m.jtprod(jvals, st.y)
        rd = torch.cat([grad + jty, -st.y]) - st.zl + st.zu
        rp = cval - st.s
        compl_l = torch.where(has_l, (z - lz) * st.zl - mu, 0.0)
        compl_u = torch.where(has_u, (uz - z) * st.zu - mu, 0.0)
        nb = torch.sum(has_l) + torch.sum(has_u)
        ny = m.ncon
        smax = o["s_max"]
        ssum = torch.sum(torch.abs(st.y)) + torch.sum(torch.abs(st.zl)) + \
            torch.sum(torch.abs(st.zu))
        sd = torch.clamp(ssum / torch.clamp(ny + nb, min=1), min=smax) / smax
        sc_ = torch.clamp(
            (torch.sum(torch.abs(st.zl)) + torch.sum(torch.abs(st.zu)))
            / torch.clamp(nb, min=1), min=smax) / smax
        inf_du = _amax(torch.abs(rd))
        inf_pr = _amax(torch.abs(rp))
        inf_comp = torch.maximum(_amax0(torch.abs(compl_l)),
                                 _amax0(torch.abs(compl_u)))
        E = torch.maximum(torch.maximum(inf_du / sd, inf_pr), inf_comp / sc_)
        return E, inf_pr, inf_du, inf_comp, sd, sc_

    # ------------------------------------------------------------------
    # merit pieces
    # ------------------------------------------------------------------
    def _phi(self, x, s, fval, lz, uz, consts, mu):
        z = torch.cat([x, s])
        has_l, has_u = consts["has_l"], consts["has_u"]
        dl = torch.where(has_l, z - lz, 1.0)
        du = torch.where(has_u, uz - z, 1.0)
        # log of nonpositive slack -> +inf barrier (trial point rejected)
        bl = torch.where(has_l, -torch.log(dl), 0.0)
        bu = torch.where(has_u, -torch.log(du), 0.0)
        phi = fval + mu * (torch.sum(bl) + torch.sum(bu))
        # Waechter-Biegler bound damping (§3.7, Ipopt kappa_d): linear terms
        # on one-sided-bounded variables keep degenerate multipliers bounded
        kd = self.opts["kappa_d"]
        damp_l = has_l & ~has_u
        damp_u = has_u & ~has_l
        phi = phi + kd * mu * (torch.sum(torch.where(damp_l, dl, 0.0))
                               + torch.sum(torch.where(damp_u, du, 0.0)))
        return phi

    # ------------------------------------------------------------------
    # one IPM iteration
    # ------------------------------------------------------------------
    def _step(self, st: IpmState, consts, kkt=None):
        """One IPM iteration from ``st``, in five spans: the iterate's
        evaluations and KKT error (``ipm.eval``), the barrier update
        (``ipm.barrier``), the regularized Newton direction
        (``ipm.direction``), the line search (``ipm.line_search``) and the
        dual step, filter and state (``ipm.update``)."""
        with phases() as phase:
            return self._step_phases(st, consts, kkt, phase)

    def _step_phases(self, st, consts, kkt, phase):
        phase("ipm.eval")
        kkt = kkt if kkt is not None else self.kkt
        m = self.model
        o = self.opts
        dt = m.dtype
        dev = m.device
        n, mm = m.nvar, m.ncon
        has_l, has_u = consts["has_l"], consts["has_u"]
        tol = consts["tol"]
        inf = float("inf")

        # tiny-slack correction: if a bound distance has collapsed to the
        # floating-point cancellation level (lifted equality slacks do this
        # when c(x) sits outside the relaxation window), move the bound
        # outward by eps^(3/4)*max(1,|b|) so Sigma stays representable
        eps = torch.finfo(dt).eps
        z_all = torch.cat([st.x, st.s])
        maxl = torch.clamp(torch.abs(st.lz), min=1.0)
        maxu = torch.clamp(torch.abs(st.uz), min=1.0)
        lz = torch.where(has_l & (z_all - st.lz < 10 * eps * maxl),
                         st.lz - eps ** 0.75 * maxl, st.lz)
        uz = torch.where(has_u & (st.uz - z_all < 10 * eps * maxu),
                         st.uz + eps ** 0.75 * maxu, st.uz)
        st = st._replace(lz=lz, uz=uz)

        fval_u, grad_u = m.obj_and_grad(st.x, consts["theta"])
        fval = fval_u * m.sense * consts["sf"]
        grad = grad_u * m.sense * consts["sf"]
        cval_u, jvals_u = m.cons_and_jac(st.x, consts["theta"])
        cval = cval_u * consts["sc"]
        jvals = jvals_u * consts["sc"][m.jac_rows]

        # -- convergence -------------------------------------------------
        zero = torch.zeros((), dtype=dt, device=dev)
        E0, inf_pr, inf_du, inf_comp, sd, sc_ = self._kkt_error(
            st, consts, grad, jvals, cval, zero)
        converged = E0 <= tol
        # Ipopt-style acceptable criteria: scaled overall error within
        # acceptable_tol AND the component-wise guards
        acc_now = ((E0 <= consts["acceptable_tol"])
                   & (inf_pr <= o["acceptable_constr_viol_tol"])
                   & (inf_du / sd <= o["acceptable_dual_inf_tol"])
                   & (inf_comp / sc_ <= o["acceptable_compl_inf_tol"]))
        acceptable_count = torch.where(acc_now, st.acceptable_count + 1, 0)
        acc_done = acceptable_count >= consts["acceptable_iter"]
        bad = ~torch.isfinite(E0)
        diverged = (torch.abs(fval) > 1e20) | (_amax(torch.abs(st.x)) > 1e20)

        # best-iterate tracker + near-optimal VISIT counter (degenerate-
        # endgame limit-cycle escape): the visit/best metric is the KKT
        # error with the W-B scalings CAPPED at s_max, so a degenerate
        # multiplier ray cannot make a far-from-optimal point look
        # stationary; at acceptable_visit_limit visits the solve returns
        # "acceptable" with the best iterate restored (Ipopt:
        # SOLVED_TO_ACCEPTABLE_LEVEL)
        E_cap = torch.maximum(
            torch.maximum(inf_du / torch.clamp(sd, max=o["s_max"]), inf_pr),
            inf_comp / torch.clamp(sc_, max=o["s_max"]))
        # objective sanity guard: a near-KKT candidate far above the best
        # feasible-ish objective is a spurious stationary point and must
        # not be stored/restored
        feasish = inf_pr <= 1e2 * tol
        feas_fobj = torch.where(feasish, torch.minimum(st.feas_fobj, fval),
                                st.feas_fobj)
        obj_bound = feas_fobj + o["restore_obj_guard"] * torch.clamp(
            torch.abs(feas_fobj), min=1.0)
        obj_ok = fval <= obj_bound
        stale = torch.isfinite(st.best_fobj) & (st.best_fobj > obj_bound)
        prev_best_E = torch.where(stale, inf, st.best_E)
        visit = ((E_cap <= o["acceptable_visit_tol_factor"] * tol)
                 & (inf_pr <= 1e2 * tol) & obj_ok)
        acc_visits = st.acc_visits + visit.to(torch.int32)
        better = (E_cap < prev_best_E) & obj_ok
        best_E = torch.where(better, E_cap, prev_best_E)
        best_fobj = torch.where(better, fval, st.best_fobj)
        best_inf_pr = torch.where(better, inf_pr, st.best_inf_pr)
        best_inf_du = torch.where(better, inf_du, st.best_inf_du)
        best_x = torch.where(better, st.x, st.best_x)
        best_s = torch.where(better, st.s, st.best_s)
        best_y = torch.where(better, st.y, st.best_y)
        best_zl = torch.where(better, st.zl, st.best_zl)
        best_zu = torch.where(better, st.zu, st.best_zu)
        cycle_stop = ((acc_visits >= o["acceptable_visit_limit"])
                      & ~converged & torch.isfinite(best_E))

        status = torch.where(
            converged, FIRST_ORDER,
            torch.where(bad, INVALID,
                        torch.where(diverged, DIVERGED,
                                    torch.where(acc_done | cycle_stop,
                                                ACCEPTABLE, RUNNING))))

        # -- barrier update (may fire repeatedly) -------------------------
        phase("ipm.barrier")
        # adaptive mode: the next mu is the LOQO centrality rule
        # sigma = 0.1*min(0.05*(1-xi)/xi, 2)^3 applied to the average
        # complementarity, clipped into [monotone schedule, 0.8*mu]
        if o["barrier"] == "adaptive":
            z0 = torch.cat([st.x, st.s])
            cp = torch.cat([torch.where(has_l, (z0 - lz) * st.zl, 0.0),
                            torch.where(has_u, (uz - z0) * st.zu, 0.0)])
            cmask = torch.cat([has_l, has_u])
            avg_c = torch.sum(torch.where(cmask, cp, 0.0)) / torch.clamp(
                torch.sum(cmask), min=1)
            min_c = _amin_inf(torch.where(cmask, cp, inf))
            xi = min_c / torch.clamp(avg_c, min=torch.finfo(dt).tiny)
            sig_c = 0.1 * torch.clamp(
                0.05 * (1.0 - xi) / torch.clamp(xi, min=1e-12), max=2.0) ** 3
            mu_loqo = sig_c * avg_c
        mu, tau = st.mu, st.tau
        filter_len, filter_theta, filter_phi = (st.filter_len,
                                                st.filter_theta,
                                                st.filter_phi)
        mu_floor = tol * o["mu_min_fraction"]
        while True:
            E_mu = self._kkt_error(st, consts, grad, jvals, cval, mu)[0]
            if not _read((E_mu <= o["kappa_epsilon"] * mu)
                         & (mu > mu_floor)):
                break
            mu_new = torch.maximum(
                mu_floor,
                torch.minimum(o["kappa_mu"] * mu, mu ** o["theta_mu"]))
            if o["barrier"] == "adaptive":
                mu_new = torch.minimum(torch.maximum(mu_loqo, mu_new),
                                       0.8 * mu)
            tau = torch.clamp(1.0 - mu_new, min=o["tau_min"])
            # reset filter to the theta_max entry only
            ft_new = torch.full_like(filter_theta, inf)
            ft_new[0] = filter_theta[0]
            filter_theta = ft_new
            filter_phi = torch.full_like(filter_phi, -inf)
            filter_len = _i32(1, dev)
            mu = mu_new

        # -- barrier-scaled quantities ------------------------------------
        phase("ipm.direction")
        z = torch.cat([st.x, st.s])
        dl = torch.where(has_l, z - lz, 1.0)
        du = torch.where(has_u, uz - z, 1.0)
        sig_l = torch.where(has_l, st.zl / dl, 0.0)
        sig_u = torch.where(has_u, st.zu / du, 0.0)
        sigma = sig_l + sig_u                       # (n+m,)
        mu_dl = torch.where(has_l, mu / dl, 0.0)
        mu_du = torch.where(has_u, mu / du, 0.0)

        # bound-damping gradient contribution (one-sided bounds only)
        kd = o["kappa_d"]
        damp = kd * mu * ((has_l & ~has_u).to(dt) - (has_u & ~has_l).to(dt))
        jty = m.jtprod(jvals, st.y)
        rx = grad + jty - mu_dl[:n] + mu_du[:n] + damp[:n]
        rs = -st.y - mu_dl[n:] + mu_du[n:] + damp[n:]
        rp = cval - st.s

        # -- condensed system with inertia-free regularization ------------
        sigma_x, sigma_s = sigma[:n], sigma[n:]
        # mu-floored dual regularization: caps D = 1/(1/Sigma_s+dc) for the
        # lifted equality rows, keeping the condensed system factorizable
        delta_c_floor = o["delta_c_bar"] * \
            torch.clamp(mu, min=o["delta_c_mu_floor"]) ** 0.25

        # dual-ray proximal damping (the ray_* options): zero everywhere
        # except inside a live ray signature; with its proximal pull on the
        # capped excess of y.  Both are None when the option is off, and so
        # is the mu-scaled dual-step damping (prox_dual_kappa), gated on mu
        # so the global phase's basin is untouched: the default step runs
        # none of their elementwise work
        delta_prox = prox_pull = delta_pd = None
        if o["ray_damping"]:
            ray_live = ((_amax0(torch.abs(st.y)) > o["ray_y_cap"])
                        & (inf_pr <= 1e2 * tol)
                        & (inf_du / torch.clamp(sd, max=o["s_max"])
                           > o["acceptable_visit_tol_factor"] * tol))
            delta_prox = torch.where(ray_live, o["ray_delta"], zero)
            prox_pull = delta_prox * (
                st.y - torch.clamp(st.y, -o["ray_y_cap"], o["ray_y_cap"]))
        if o["prox_dual_kappa"]:
            delta_pd = torch.where(mu <= o["prox_dual_mu_max"],
                                   o["prox_dual_kappa"] * mu, zero)

        def damped(d):
            """``d`` plus the dual damping that is on (in the reference's
            order of additions)."""
            if delta_prox is not None:
                d = d + delta_prox
            if delta_pd is not None:
                d = d + delta_pd
            return d

        def pulled(r):
            return r if prox_pull is None else r - prox_pull

        # the f32 step sets demote to the f64 one on a refinement failure
        # instead of walking the regularization ladder: a precision failure
        # is not an inertia failure, and bumping delta_w for it damps the
        # Newton direction into a crawl.  "mixed"/"float32" refine against
        # their own f32 K and are held to the f32 thresholds; "ir32" refines
        # matrix-free against the exact f64 operator, aims at the f64 target
        # and accepts a step at least as good as a pure-f32 one
        can_demote = kkt is self.kkt32 and kkt is not None
        ir_ref = can_demote and o["factor_dtype"] == "ir32"
        sfx = "_f32" if can_demote and not ir_ref else ""
        refine_tol = o["refine_tol" + sfx]
        refine_accept = o["refine_accept_f32" if ir_ref
                          else "refine_accept" + sfx]
        refine_max = o["refine_max_ir" if ir_ref else "refine_max" + sfx]
        refine_contract = o["refine_contract_ir" if ir_ref
                            else "refine_contract"]
        if ir_ref:
            # both tighten with this iteration's mu: the acceptance floored
            # at f32 quality, the target down to refine_tol
            refine_accept = torch.clamp(o["refine_mu_factor_ir"] * mu,
                                        refine_accept, 1e-2)
            refine_tol = torch.clamp(0.05 * o["refine_mu_factor_ir"] * mu,
                                     refine_tol, o["refine_tol_cap_ir"])
        # (the reference's f64 step set also has a branch for f32
        # refinement residuals on the TPU, where f64 is emulated; it is
        # TPU-only and not ported)
        tiny = torch.finfo(dt).tiny

        def refine_pcg(fac, rhs, dx, rhs_norm, D, diag_extra):
            """ir32: CG on the exact f64 operator, preconditioned by the f32
            factorization; returns the best iterate and its relative
            residual."""
            lam_s = st.y * consts["sc"]

            def Kmv(w):
                # matrix-free: one Hessian-vector sweep, two COO J products
                # and the condensed diagonal
                return (m.hvp_lag(st.x, consts["theta"], lam_s,
                                  consts["sf"] * m.sense, w)
                        + m.jtprod(jvals, D * m.jprod(jvals, w))
                        + diag_extra * w)

            r = rhs - Kmv(dx)
            z = kkt.solve(fac, r)
            p, rz = z, torch.dot(r, z)
            x = best_x = dx
            best_rr = torch.linalg.norm(r) / rhs_norm
            prev_best = torch.full((), inf, dtype=dt, device=dev)
            i = 0
            while i < refine_max and _read(
                    (best_rr > refine_tol)
                    & (best_rr < refine_contract * prev_best)):
                Kp = Kmv(p)
                pKp = torch.dot(p, Kp)
                # non-SPD curvature or breakdown freezes the iterate (the
                # loop then stops on stalled progress)
                good = pKp > 0
                alpha = torch.where(good, rz / torch.where(good, pKp, 1.0),
                                    0.0)
                x = x + alpha * p
                r = r - alpha * Kp
                z = kkt.solve(fac, r)
                rz_new = torch.dot(r, z)
                beta = torch.where(good & (rz != 0), rz_new / rz, 0.0)
                p, rz = z + beta * p, rz_new
                rr = torch.linalg.norm(r) / rhs_norm
                better = rr < best_rr
                prev_best = best_rr
                best_x = torch.where(better, x, best_x)
                best_rr = torch.where(better, rr, best_rr)
                i += 1
                count("kkt.refine_rounds")
            return best_x, best_rr

        def make_step(delta_w, delta_c):
            inv_ss = 1.0 / (sigma_s + delta_w)
            D = 1.0 / damped(inv_ss + delta_c)
            diag_extra = sigma_x + delta_w
            # model-side values are for UNSCALED f and c: fold scalings in
            # (internal y multiplies scaled c_i = sc_i*c_i; scaled J = sc*J)
            sc = consts["sc"]
            with span("kkt.assemble"):
                K = kkt.assemble(st.x, consts["theta"], st.y * sc,
                                 consts["sf"] * m.sense, D * sc * sc,
                                 diag_extra)
            with span("kkt.factor"):
                fac, ok = kkt.factor(K)

            rhs2 = pulled(rp + inv_ss * rs)
            rhs = -(rx + m.jtprod(jvals, D * rhs2))
            with span("kkt.solve"):
                # where the backend refines: on the aligned sharded
                # backends the T-layout (each rank's own block slots plus
                # the replicated border), where a round takes no O(n)
                # collective and bring_out the step's one all-gather
                space = kkt.refinement(fac, K)
                if space is None:
                    # an exact backend (the host LDL) needs no refinement
                    dx = kkt.solve(fac, rhs)
                    rr_final = zero
                    ref_ok = torch.ones((), dtype=torch.bool, device=dev)
                elif ir_ref:
                    # ir32 refines against the model's operator, which
                    # needs the replicated vector every round
                    dx, rr_final = refine_pcg(
                        fac, rhs, kkt.solve(fac, rhs),
                        torch.linalg.norm(rhs) + tiny, D, diag_extra)
                    ref_ok = rr_final <= refine_accept
                else:
                    # residual-driven iterative refinement of the CONDENSED
                    # solve: exits early when the relative residual is
                    # small or stops contracting; a final residual above
                    # refine_accept marks the step failed so the
                    # regularization ladder escalates (or the f32 step set
                    # demotes)
                    rhs_v = space.bring_in(rhs)
                    rhs_norm = torch.linalg.norm(rhs) + tiny
                    dx = space.solve(rhs_v)
                    resid = space.sub(rhs_v, space.matvec(dx))
                    prev = torch.full((), inf, dtype=dt, device=dev)
                    i = 0
                    while True:
                        rr = space.norm(resid) / rhs_norm
                        if not (i < refine_max and _read(
                                (rr > refine_tol)
                                & (rr < refine_contract * prev))):
                            break
                        count("kkt.refine_rounds")
                        dxn = space.add(dx, space.solve(resid))
                        residn = space.sub(rhs_v, space.matvec(dxn))
                        rrn = space.norm(residn) / rhs_norm
                        # keep the better iterate if refinement diverges
                        worse = rrn > rr
                        dx = space.where(worse, dx, dxn)
                        resid = space.where(worse, resid, residn)
                        prev = rr
                        i += 1
                    rr_final = space.norm(resid) / rhs_norm
                    ref_ok = rr_final <= refine_accept
                    dx = space.bring_out(dx)
            dy = D * (m.jprod(jvals, dx) + rhs2)
            ds = inv_ss * (dy - rs)
            ok = ok & torch.isfinite(dx).all() & \
                torch.isfinite(dy).all() & torch.isfinite(ds).all()
            # the factorization travels out of the regularization ladder so
            # the second-order correction can reuse it
            return dx, ds, dy, ok, ref_ok, rr_final, fac

        # sticky regularization: while the zero probe has a live failure
        # streak, start the ladder directly at the warm value it would have
        # retried with; reprobe zero periodically
        warm_dw = torch.clamp(o["kappa_w_minus"] * st.delta_w_last,
                              min=o["delta_w_min"])
        skip_zero = ((st.zero_fail_streak >= o["reg_zero_skip_streak"])
                     & (st.iter % o["reg_zero_reprobe"] != 0)
                     & (st.delta_w_last > 0.0))
        first_dw = torch.where(skip_zero, warm_dw, 0.0)
        bump_from_zero = torch.where(st.delta_w_last == 0.0,
                                     o["delta_w_init"], warm_dw)
        kw_plus = torch.where(st.delta_w_last == 0.0,
                              o["kappa_w_plus_init"], o["kappa_w_plus"])

        dx = torch.zeros(n, dtype=dt, device=dev)
        ds = torch.zeros(mm, dtype=dt, device=dev)
        dy = torch.zeros(mm, dtype=dt, device=dev)
        dw = zero
        dw_used = zero
        rr_f = zero
        ok_f = torch.zeros((), dtype=torch.bool, device=dev)
        fac_f = None
        tries = 0
        # a precision failure of an f32 step set (factorization fine,
        # refinement short of its acceptance) ends the ladder: the host
        # hands the state to the f64 step set
        need_demote = ladder_done = ok_f
        while tries < o["max_reg_tries"] and not _read(ladder_done):
            if tries == 0:
                dw_new = first_dw
            else:
                # each retry assembles again, and so re-runs the Hessian sweep
                count("kkt.regularizations")
                dw_new = torch.where(dw == 0.0, bump_from_zero, dw * kw_plus)
            dx, ds, dy, fac_ok, ref_ok, rr_f, fac_f = make_step(
                dw_new, delta_c_floor)
            ok_f = ladder_done = fac_ok & ref_ok
            if can_demote:
                need_demote = fac_ok & ~ref_ok
                ladder_done = ok_f | need_demote
            dw = dw_used = dw_new
            tries += 1
        if can_demote:
            status = torch.where((status == RUNNING) & need_demote,
                                 DEMOTE_F32, status)

        def ftb_primal(dza):
            """Fraction-to-boundary step cap for a primal direction."""
            neg = dza < 0
            pos = dza > 0
            a_l = torch.where(has_l & neg,
                              -tau * dl / torch.where(neg, dza, -1.0), inf)
            a_u = torch.where(has_u & pos,
                              tau * du / torch.where(pos, dza, 1.0), inf)
            return torch.clamp(torch.minimum(_amin_inf(a_l), _amin_inf(a_u)),
                               max=1.0)

        # -- filter line search ------------------------------------------
        phase("ipm.line_search")
        alpha_max = ftb_primal(torch.cat([dx, ds]))

        theta_c = torch.sum(torch.abs(rp))
        phi_c = self._phi(st.x, st.s, fval, lz, uz, consts, mu)
        gphi_x = grad - mu_dl[:n] + mu_du[:n] + damp[:n]
        gphi_s = -mu_dl[n:] + mu_du[n:] + damp[n:]
        dphi = torch.dot(gphi_x, dx) + torch.dot(gphi_s, ds)

        gt, gp = o["gamma_theta"], o["gamma_phi"]

        def trial_at(dxa, dsa, alpha):
            with span("ipm.trial"):
                xt = st.x + alpha * dxa
                stt = st.s + alpha * dsa
                ft = self._feval(xt, consts)
                ct = self._ceval(xt, consts)
                theta_t = torch.sum(torch.abs(ct - stt))
                phi_t = self._phi(xt, stt, ft, lz, uz, consts, mu)
                return theta_t, phi_t

        idx = torch.arange(FILTER_SIZE, device=dev)

        def acceptable_to_filter(theta_t, phi_t):
            # filter entries are stored WITH their margins applied
            # ((1-gt)*theta_k, phi_k - gp*theta_k), so the test is raw
            active = idx < filter_len
            dominated = active & (theta_t >= filter_theta) & \
                (phi_t >= filter_phi)
            return ~torch.any(dominated)

        def accept_test(alpha, theta_t, phi_t):
            finite = torch.isfinite(theta_t) & torch.isfinite(phi_t)
            in_filter = acceptable_to_filter(theta_t, phi_t)
            switching = (dphi < 0) & \
                (alpha * (-dphi) ** o["s_phi"] >
                 o["delta"] * theta_c ** o["s_theta"])
            armijo = phi_t <= phi_c + o["eta_phi"] * alpha * dphi
            progress = (theta_t <= (1 - gt) * theta_c) | \
                (phi_t <= phi_c - gp * theta_c)
            acc = finite & in_filter & \
                torch.where(switching, armijo, progress)
            return acc, switching & armijo

        # first trial at alpha_max with the uncorrected direction
        theta_t0, phi_t0 = trial_at(dx, ds, alpha_max)
        acc0, ftype0 = accept_test(alpha_max, theta_t0, phi_t0)

        if o["soc"]:
            # -- second-order correction (Ipopt A-5.7..5.9 role): when the
            # full step is rejected with theta not improving, solve the SAME
            # factorized KKT once more with the post-step constraint
            # violation as rhs and test the corrected step before falling
            # back to backtracking
            inv_ss_f = 1.0 / (sigma_s + dw_used)
            D_f = 1.0 / damped(inv_ss_f + delta_c_floor)
            need_soc = ok_f & (~acc0) & (theta_t0 >= theta_c)
            use_soc = torch.zeros((), dtype=torch.bool, device=dev)
            if _read(need_soc):
                count("ipm.soc_trials")
                stt = st.s + alpha_max * ds
                ct = self._ceval(st.x + alpha_max * dx, consts)
                rp_soc = alpha_max * rp + (ct - stt)
                rhs2s = pulled(rp_soc + inv_ss_f * rs)
                rhs_s = -(rx + m.jtprod(jvals, D_f * rhs2s))
                with span("kkt.solve"):
                    dxs = kkt.solve(fac_f, rhs_s)
                dys = D_f * (m.jprod(jvals, dxs) + rhs2s)
                dss = inv_ss_f * (dys - rs)
                good = (torch.isfinite(dxs).all()
                        & torch.isfinite(dss).all()
                        & torch.isfinite(dys).all())
                a_soc = ftb_primal(torch.cat([dxs, dss]))
                th_s, ph_s = trial_at(dxs, dss, a_soc)
                # W-B tests the corrected point against the ORIGINAL
                # step's alpha_max
                acc_s, ftype_s = accept_test(alpha_max, th_s, ph_s)
                # kappa_soc guard (W-B A-5.9): the correction must REDUCE
                # infeasibility
                use_soc = good & acc_s & (th_s <= 0.99 * theta_c)
            if _read(use_soc):
                dx, ds, dy = dxs, dss, dys
                start_alpha = a_soc
                theta_init, phi_init, ftype_init = th_s, ph_s, ftype_s
            else:
                start_alpha = torch.where(acc0, alpha_max, 0.5 * alpha_max)
                theta_init, phi_init, ftype_init = theta_t0, phi_t0, ftype0
            start_acc = acc0 | use_soc
        else:
            start_alpha = torch.where(acc0, alpha_max, 0.5 * alpha_max)
            start_acc = acc0
            theta_init, phi_init, ftype_init = theta_t0, phi_t0, ftype0

        alpha, accepted, f_type = start_alpha, start_acc, ftype_init
        ls_iters = 1
        while ls_iters < o["max_backtracks"] and not _read(accepted):
            theta_t, phi_t = trial_at(dx, ds, alpha)
            acc, f_type = accept_test(alpha, theta_t, phi_t)
            alpha = torch.where(acc, alpha, alpha * 0.5)
            accepted = acc
            ls_iters += 1

        # dual directions from complementarity linearization (for the
        # FINAL direction, post-SOC) + their fraction-to-boundary cap
        phase("ipm.update")
        dz = torch.cat([dx, ds])
        acl = torch.where(has_l, dl * st.zl - mu, 0.0)
        acu = torch.where(has_u, du * st.zu - mu, 0.0)
        dzl = torch.where(has_l, -sig_l * dz - acl / dl, 0.0)
        dzu = torch.where(has_u, sig_u * dz - acu / du, 0.0)
        negl = dzl < 0
        negu = dzu < 0
        a_zl = torch.where(has_l & negl,
                           -tau * st.zl / torch.where(negl, dzl, -1.0), inf)
        a_zu = torch.where(has_u & negu,
                           -tau * st.zu / torch.where(negu, dzu, -1.0), inf)
        alpha_z = torch.clamp(torch.minimum(_amin_inf(a_zl), _amin_inf(a_zu)),
                              max=1.0)

        # augment filter unless the accepted step was an f-type (Armijo) step
        add_to_filter = accepted & ~f_type
        slot = torch.clamp(filter_len, max=FILTER_SIZE - 1)
        at_slot = idx == slot
        filter_theta = torch.where(add_to_filter & at_slot,
                                   (1 - gt) * theta_c, filter_theta)
        filter_phi = torch.where(add_to_filter & at_slot,
                                 phi_c - gp * theta_c, filter_phi)
        filter_len = torch.where(add_to_filter,
                                 torch.clamp(filter_len + 1,
                                             max=FILTER_SIZE),
                                 filter_len)

        # -- updates ------------------------------------------------------
        # Line-search failure fallback: keep the primal point, damp the
        # multipliers and recenter the bound duals on the current barrier
        # target, reset the filter, and try again; repeated failures enter
        # the restoration phase (or stall out)
        failed = ~accepted
        if can_demote:
            # a repeated line-search failure in an f32 step set is more
            # likely a precision-poisoned direction than an unusable Newton
            # step: hand the unchanged state to the f64 step set instead of
            # resetting the multipliers.  The first failure gets the f64
            # recovery (iteration 1 often fails from the pushed start)
            demote_ls = failed & (st.ls_fail_count >= 1)
            status = torch.where((status == RUNNING) & demote_ls,
                                 DEMOTE_F32, status)
            failed = failed & ~demote_ls
        alpha = torch.where(failed, 0.0, alpha)
        cap = o["y_reset_cap"]
        # reheat the barrier on failure
        mu = torch.where(failed,
                         torch.clamp(torch.clamp(10.0 * inf_pr, min=mu),
                                     max=0.1), mu)
        tau = torch.where(failed,
                          torch.clamp(1.0 - mu, min=o["tau_min"]), tau)
        x_new = st.x + alpha * dx
        s_new = st.s + alpha * ds
        y_new = torch.where(failed, torch.clamp(st.y, -cap, cap),
                            st.y + alpha * dy)
        zl_reset = torch.where(has_l, mu / dl, 0.0)
        zu_reset = torch.where(has_u, mu / du, 0.0)
        zl_new = torch.where(failed, zl_reset, st.zl + alpha_z * dzl)
        zu_new = torch.where(failed, zu_reset, st.zu + alpha_z * dzu)
        ft_reset = torch.where(idx == 0, filter_theta[0], inf)
        filter_theta = torch.where(failed, ft_reset, filter_theta)
        filter_phi = torch.where(failed, -inf, filter_phi)
        filter_len = torch.where(failed, 1, filter_len)
        ls_fail_count = torch.where(failed, st.ls_fail_count + 1, 0)
        z_new = torch.cat([x_new, s_new])
        dln = torch.where(has_l, z_new - lz, 1.0)
        dun = torch.where(has_u, uz - z_new, 1.0)
        ks = o["kappa_sigma"]
        zl_new = torch.where(
            has_l, torch.clamp(zl_new, mu / (ks * dln), ks * mu / dln), 0.0)
        zu_new = torch.where(
            has_u, torch.clamp(zu_new, mu / (ks * dun), ks * mu / dun), 0.0)

        # small-step detection
        step_sz = alpha * _amax0(torch.abs(dz) / (1.0 + torch.abs(z)))
        small = (step_sz < 10 * eps) & accepted
        small_count = torch.where(small, st.small_step_count + 1, 0)
        status = torch.where(
            (status == RUNNING) & (ls_fail_count >= o["max_ls_failures"]),
            NEED_RESTORATION if o["restoration"] else STALLED, status)
        status = torch.where((status == RUNNING) & (small_count >= 3),
                             STALLED, status)

        stop = status != RUNNING
        # limit-cycle stop: hand back the BEST iterate seen, not wherever
        # in the overshoot cycle the visit counter happened to fire
        restore = cycle_stop & (status == ACCEPTABLE)

        def keep(new, old):
            return torch.where(stop, old, new)

        def pick_b(best, cur):
            return torch.where(restore, best, cur)

        def i32(t):
            return t.to(torch.int32)

        return IpmState(
            x=pick_b(best_x, keep(x_new, st.x)),
            s=pick_b(best_s, keep(s_new, st.s)),
            y=pick_b(best_y, keep(y_new, st.y)),
            zl=pick_b(best_zl, keep(zl_new, st.zl)),
            zu=pick_b(best_zu, keep(zu_new, st.zu)),
            lz=lz, uz=uz,
            mu=mu, tau=tau,
            delta_w_last=torch.where(dw_used > 0, dw_used, st.delta_w_last),
            # streak bookkeeping: only iterations that actually PROBED zero
            # update it (failure -> +1, success -> reset)
            zero_fail_streak=i32(torch.where(
                skip_zero, st.zero_fail_streak,
                torch.where(dw_used > 0, st.zero_fail_streak + 1, 0))),
            filter_theta=filter_theta, filter_phi=filter_phi,
            filter_len=i32(filter_len),
            iter=i32(st.iter + torch.where(stop, 0, 1)),
            status=i32(status),
            acceptable_count=i32(acceptable_count),
            small_step_count=i32(small_count),
            ls_fail_count=i32(ls_fail_count),
            acc_visits=i32(acc_visits),
            best_E=best_E, best_inf_pr=best_inf_pr,
            best_inf_du=best_inf_du,
            best_fobj=best_fobj, feas_fobj=feas_fobj,
            best_x=best_x, best_s=best_s, best_y=best_y,
            best_zl=best_zl, best_zu=best_zu,
            log_obj=fval,
            log_inf_pr=pick_b(best_inf_pr, inf_pr),
            log_inf_du=pick_b(best_inf_du, inf_du),
            log_alpha=alpha, log_alpha_z=alpha_z,
            log_ls=_i32(ls_iters, dev),
            log_delta_w=dw_used, log_rr=rr_f, log_E0=E0,
        )

    def _lsq_duals(self, st, consts):
        """Least-squares equality multipliers at ``st`` (Ipopt
        ``least_square_init_duals`` role).  With the lifted slack rows the
        stationarity residual is ``[g - zl_x + zu_x + J^T y;
        -(y + zl_s - zu_s)]``, whose normal equations are
        ``(J J^T + I) y = -J r_x - zl_s + zu_s``; the ``+ I`` from the
        slack rows makes plain CG well-conditioned.  Matrix-free: two COO
        J-products per CG round, no factorization.  The result is bounded
        by ``~||J^+|| ||r||`` however degenerate the active set is."""
        m = self.model
        n = m.nvar
        tiny = torch.finfo(m.dtype).tiny
        jvals = self._jvals(st.x, consts)
        rx = self._geval(st.x, consts) - st.zl[:n] + st.zu[:n]
        b = -m.jprod(jvals, rx) - st.zl[n:] + st.zu[n:]
        bb = torch.dot(b, b)
        y = torch.zeros(m.ncon, dtype=m.dtype, device=m.device)
        p, r, rs = b, b, bb
        k = 0
        while k < 200 and _read(rs > 1e-24 * bb):
            Ap = m.jprod(jvals, m.jtprod(jvals, p)) + p
            alpha = rs / (torch.dot(p, Ap) + tiny)
            y = y + alpha * p
            r = r - alpha * Ap
            rs_new = torch.dot(r, r)
            p = r + (rs_new / (rs + tiny)) * p
            rs = rs_new
            k += 1
        return y

    def _dual_inf(self, st, consts):
        """The dual infeasibility of ``st`` at its barrier mu, measured as
        ``log_inf_du`` is."""
        grad = self._geval(st.x, consts)
        jv = self._jvals(st.x, consts)
        cval = self._ceval(st.x, consts)
        return self._kkt_error(st, consts, grad, jv, cval, st.mu)[2]

    # ------------------------------------------------------------------
    # feasibility restoration (role of Ipopt §3.3, which the reference
    # inherits through its ext glue at
    # InfiniteExaModels.jl/ext/InfiniteExaModelsIpopt.jl:48-50): damped
    # Gauss-Newton (Levenberg-Marquardt) descent on
    #     theta(x) = 1/2 ||c(x) - mid(c(x))||^2 + zeta/2 ||D_R (x-x_R)||^2
    # where mid() clips onto the slack bounds, reusing the SAME condensed
    # assemble/factor/solve path (lam=0, sigma=0, d=sc^2 gives exactly
    # J^T J on the Hessian sparsity pattern).
    # ------------------------------------------------------------------
    def _restore(self, st: IpmState, consts):
        m = self.model
        o = self.opts
        dt = m.dtype
        dev = m.device
        n = m.nvar
        inf = float("inf")
        has_l, has_u = consts["has_l"], consts["has_u"]
        lzx, uzx = st.lz[:n], st.uz[:n]
        lzs, uzs = st.lz[n:], st.uz[n:]
        hl_x, hu_x = has_l[:n], has_u[:n]
        hl_s, hu_s = has_l[n:], has_u[n:]
        sc = consts["sc"]
        x_ref = st.x
        # Ipopt-style proximal scaling D_R = min(1, 1/|x_R|)
        DR = torch.clamp(1.0 / torch.clamp(torch.abs(x_ref), min=1e-8),
                         max=1.0)
        zeta = o["resto_zeta"] * torch.sqrt(torch.clamp(st.mu, min=1e-12))

        def violation(c):
            mid = torch.minimum(
                torch.maximum(c, torch.where(hl_s, lzs, -inf)),
                torch.where(hu_s, uzs, inf))
            return c - mid

        def theta_of(x):
            r = violation(self._ceval(x, consts))
            prox = x - x_ref
            th = 0.5 * (torch.dot(r, r) + zeta * torch.dot(DR * prox, prox))
            return th, torch.dot(r, r)

        # exit once the raw violation is far below the tolerance the main
        # loop needs (the proximal term keeps theta itself > 0)
        r2_exit = (0.01 * consts["tol"]) ** 2
        x = st.x
        delta = torch.as_tensor(o["resto_delta_init"], dtype=dt, device=dev)
        th, r2 = theta_of(x)
        it = 0
        while it < o["resto_max_iter"] and _read(r2 > r2_exit):
            cval, jvals = m.cons_and_jac(x, consts["theta"])
            cval = cval * sc
            jvals = jvals * sc[m.jac_rows]
            r = violation(cval)
            grad_phi = m.jtprod(jvals, r) + zeta * DR * (x - x_ref)
            zero_y = torch.zeros(m.ncon, dtype=dt, device=dev)
            with span("kkt.assemble"):
                K = self.kkt.assemble(x, consts["theta"], zero_y,
                                      torch.zeros((), dtype=dt, device=dev),
                                      sc * sc, zeta * DR + delta)
            with span("kkt.factor"):
                fac, okf = self.kkt.factor(K)
            with span("kkt.solve"):
                dx = self.kkt.solve(fac, -grad_phi)
            okf = okf & torch.isfinite(dx).all()
            # fraction-to-boundary on the variable box
            neg, pos = dx < 0, dx > 0
            a_l = torch.where(hl_x & neg,
                              -0.99 * (x - lzx) / torch.where(neg, dx, -1.0),
                              inf)
            a_u = torch.where(hu_x & pos,
                              0.99 * (uzx - x) / torch.where(pos, dx, 1.0),
                              inf)
            alpha = torch.clamp(torch.minimum(_amin_inf(a_l), _amin_inf(a_u)),
                                max=1.0)
            xt = x + alpha * dx
            th_t, r2_t = theta_of(xt)
            accept = okf & torch.isfinite(th_t) & (th_t < th)
            x = torch.where(accept, xt, x)
            delta = torch.where(
                accept, torch.clamp(delta * 0.25, min=o["resto_delta_init"]),
                torch.clamp(delta * 10.0, min=1e-6))
            th = torch.where(accept, th_t, th)
            r2 = torch.where(accept, r2_t, r2)
            it += 1

        # re-enter the main IPM: slacks recentred inside their bounds,
        # multipliers re-estimated conservatively, filter reset
        c = self._ceval(x, consts)
        k1, k2 = o["bound_push"], o["bound_frac"]
        both = hl_s & hu_s
        width = torch.where(both, uzs - lzs, 1.0)
        pl = torch.where(both,
                         torch.minimum(k1 * torch.clamp(torch.abs(lzs),
                                                        min=1.0),
                                       k2 * width),
                         k1 * torch.clamp(torch.abs(lzs), min=1.0))
        pu = torch.where(both,
                         torch.minimum(k1 * torch.clamp(torch.abs(uzs),
                                                        min=1.0),
                                       k2 * width),
                         k1 * torch.clamp(torch.abs(uzs), min=1.0))
        s = c
        s = torch.where(hl_s, torch.maximum(s, lzs + pl), s)
        s = torch.where(hu_s, torch.minimum(s, uzs - pu), s)
        mu = torch.clamp(st.mu, min=1e-6)
        z_all = torch.cat([x, s])
        dl = torch.where(has_l, z_all - st.lz, 1.0)
        du = torch.where(has_u, st.uz - z_all, 1.0)
        zl = torch.where(has_l, mu / dl, 0.0)
        zu = torch.where(has_u, mu / du, 0.0)
        ft = torch.full_like(st.filter_theta, inf)
        ft[0] = st.filter_theta[0]
        fp = torch.full_like(st.filter_phi, -inf)
        infs = torch.full((), inf, dtype=dt, device=dev)
        i0 = _i32(0, dev)
        y0 = torch.zeros_like(st.y)
        return st._replace(
            x=x, s=s, y=y0, zl=zl, zu=zu,
            mu=mu, tau=torch.clamp(1.0 - mu, min=o["tau_min"]),
            filter_theta=ft, filter_phi=fp,
            filter_len=_i32(1, dev),
            status=_i32(RUNNING, dev),
            ls_fail_count=i0, zero_fail_streak=i0, acc_visits=i0,
            best_E=infs, best_inf_pr=infs, best_inf_du=infs,
            best_fobj=infs, feas_fobj=infs,
            best_x=x, best_s=s, best_y=y0, best_zl=zl, best_zu=zu,
            small_step_count=i0, acceptable_count=i0)

    # ------------------------------------------------------------------
    # per-phase profiling
    # ------------------------------------------------------------------
    def profile_phases(self, state=None, consts=None, reps=3):
        """Wall-time the IPM step's phases separately at ``state``
        (default: the initial point): the fused model sweeps, the KKT
        values (Hessian AD sweep), assembly, factorization, one solve, one
        refinement matvec and one full step.  Each is warmed up once and
        timed over ``reps`` calls ending in a device synchronize; returns
        seconds per call."""
        m = self.model
        dt, dev = m.dtype, m.device
        if consts is None:
            consts = self._compute_consts(m.theta, m)
        if state is None:
            state = self._init_state(m.x0, m.y0, consts)
        x, theta = state.x, consts["theta"]
        lam = state.y * consts["sc"]
        sig = consts["sf"] * m.sense
        d = torch.ones(m.ncon, dtype=dt, device=dev)
        de = torch.ones(m.nvar, dtype=dt, device=dev)
        rhs = torch.ones(m.nvar, dtype=dt, device=dev)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def timed(fn):
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            return (time.perf_counter() - t0) / reps

        K = self.kkt.assemble(x, theta, lam, sig, d, de)
        prof = {
            "eval_obj_grad": timed(lambda: m.obj_and_grad(x, theta)),
            "eval_cons_jac": timed(lambda: m.cons_and_jac(x, theta)),
            "kkt_vals": timed(lambda: m.kkt_vals(x, theta, lam, sig, d)),
            "assemble": timed(
                lambda: self.kkt.assemble(x, theta, lam, sig, d, de)),
            "factor": timed(lambda: self.kkt.factor(K)),
        }
        # the solves take the last factorization: a graphed backend's
        # earlier ones are overwritten by it
        fac, _ = self.kkt.factor(K)
        prof.update({
            "solve": timed(lambda: self.kkt.solve(fac, rhs)),
            "matvec": timed(lambda: self.kkt.matvec(K, rhs)),
            "full_step": timed(lambda: self._step(state, consts)),
        })
        k32 = self.kkt32
        if k32 is not None:
            # the f32 step set's phases: its Hessian sweep, and the f32
            # factorization and solve of the same (f64-assembled) K
            prof.update({
                "kkt_vals_f32": timed(lambda: m.kkt_vals(
                    x, theta, lam, sig, d, dtype=torch.float32)),
                "factor_f32": timed(lambda: k32.factor(K)),
            })
            fac32, _ = k32.factor(K)
            prof.update({
                "solve_f32": timed(lambda: k32.solve(fac32, rhs)),
                "full_step_f32": timed(
                    lambda: self._step(state, consts, k32)),
            })
        return prof

    # ------------------------------------------------------------------
    # checkpoint / resume: the state as numpy arrays under the reference's
    # field names and dtypes, so a checkpoint of either package resumes in
    # the other
    # ------------------------------------------------------------------
    def save_checkpoint(self, path, state):
        from ..interop import state_to_numpy

        np.savez(path, **state_to_numpy(state))

    def load_checkpoint(self, path):
        from ..interop import state_from_numpy

        with np.load(path) as data:
            vals = {k: data[k] for k in data.files}
        # checkpoints written before a field existed load with its default
        vals.setdefault("log_rr", np.zeros(()))
        vals.setdefault("acc_visits", np.zeros((), np.int32))
        vals.setdefault("zero_fail_streak", np.zeros((), np.int32))
        for k in ("best_E", "best_inf_pr", "best_inf_du", "best_fobj",
                  "feas_fobj", "log_E0"):
            vals.setdefault(k, np.asarray(np.inf))
        for k in ("x", "s", "y", "zl", "zu"):
            vals.setdefault("best_" + k, vals[k])
        return state_from_numpy(vals, self.model.device)

    # ------------------------------------------------------------------
    # host loop
    # ------------------------------------------------------------------
    def solve(self, x0=None, y0=None, stats=None, resume_from=None,
              checkpoint_path=None, checkpoint_every=0, trace_dir=None,
              zl0=None, zu0=None, **options):
        """Run the IPM from ``x0``/``y0`` (default: the model's start
        values); ``zl0``/``zu0`` are user-scale variable bound duals for a
        warm start.  ``resume_from`` continues from a checkpoint, which
        ``checkpoint_path`` is rewritten with every ``checkpoint_every``
        iterations (at host returns).  With ``trace_dir``, the whole solve
        runs under ``torch.profiler`` (the CPU, and the card's kernels on
        CUDA) and its Chrome trace is written into that directory.
        ``stats`` is accepted for the reference's signature and unused."""
        args = (x0, y0, resume_from, checkpoint_path, checkpoint_every,
                zl0, zu0)
        if trace_dir is None:
            return self._solve_impl(*args, **options)
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            res = self._solve_impl(*args, **options)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(str(trace_dir),
                                              TRACE_FILE))
        return res

    def _solve_impl(self, *args, **options):
        """One solve under a span recorder of its own, whose totals the
        result carries (``spans``, ``counts``)."""
        with Recorder() as rec:
            for name in ZEROED_COUNTS:
                count(name, 0)
            with span("ipm.solve"):
                res = self._solve_loop(*args, **options)
        res.spans, res.counts = rec.spans(), rec.counts
        return res

    def _solve_loop(self, x0, y0, resume_from, checkpoint_path,
                    checkpoint_every, zl0, zu0, **options):
        if options:
            self.set_options(**options)
        o = self.opts
        m = self.model
        dev = m.device
        t_start = time.time()
        theta = m.theta
        consts = self._compute_consts(theta, m)
        x0 = m.x0 if x0 is None else torch.as_tensor(x0, dtype=m.dtype,
                                                      device=dev)
        y0 = m.y0 if y0 is None else torch.as_tensor(y0, dtype=m.dtype,
                                                      device=dev)
        # internal y is for the scaled problem: y_scaled = y_user*sf/sc*sense
        y0s = y0 * m.sense * consts["sf"] / consts["sc"]
        if resume_from is not None:
            st = self.load_checkpoint(resume_from)
        elif zl0 is not None or zu0 is not None:
            # warm bound duals (Ipopt warm_start_init_point role): the
            # slack halves are recovered from y0 through the s-row
            # stationarity y = zu_s - zl_s of this solver's KKT
            def full(z_var, y_part):
                zv = (torch.zeros(m.nvar, dtype=m.dtype, device=dev)
                      if z_var is None
                      else torch.as_tensor(z_var, dtype=m.dtype, device=dev)
                      * consts["sf"] * m.sense)
                return torch.cat([zv, y_part])
            zl_full = full(zl0, torch.clamp(-y0s, min=0.0))
            zu_full = full(zu0, torch.clamp(y0s, min=0.0))
            st = self._init_state(x0, y0s, consts, zl_full, zu_full)
        else:
            st = self._init_state(x0, y0s, consts)
        if o["dual_init"] == "lsq" and resume_from is None:
            y_lsq = self._lsq_duals(st, consts)
            st = st._replace(y=y_lsq, best_y=y_lsq)
        timers = {"step_total": 0.0, "first_chunk": np.nan}
        status = "max_iter"
        verbose = o["print_level"] >= 5
        # over a mesh every rank runs this loop on the same replicated
        # values, so every rank takes the same decisions; rank 0 alone
        # prints and writes checkpoints
        mesh = getattr(m, "mesh", None)
        lead = mesh is None or mesh.rank == 0
        say = print if lead else (lambda *a, **k: None)
        if verbose:
            say("iter    objective    inf_pr   inf_du     mu    "
                "alpha  alpha_z  ls   dw      rr      E0")
        it = 0
        resto_entries = 0
        prev_chunk_obj = None      # recalc_y_stall objective-stall gate
        chunk = 1 if verbose else HOST_CHUNK
        chunk_end = min(chunk, o["max_iter"])
        # the f32 step set runs while the mu last seen at a host return is
        # above the switch ("float32": until it demotes; "ir32": its own
        # switch, 0 by default); a step after which mu falls to the switch
        # returns to the host, as the reference's f32 chunk exits there
        if o["factor_dtype"] == "float32":
            mu_switch = 0.0
        elif o["factor_dtype"] == "ir32":
            mu_switch = o["mu_switch_ir"]
        else:
            mu_switch = o["mu_switch_f32"]
        f32_demoted = False
        mu_host = _read(st.mu, float)
        self.host_returns = []
        code, st_iter = _read(st.status, int), _read(st.iter, int)
        while it < o["max_iter"]:
            use32 = (self.kkt32 is not None and not f32_demoted
                     and mu_host > mu_switch)
            # the reference's chunk steps only a RUNNING state below its
            # cap (a resumed state may already be at it); its one-step
            # verbose loop steps regardless
            if chunk == 1 or (code == RUNNING and st_iter < chunk_end):
                t0 = time.perf_counter()
                with span("ipm.step"):
                    st = self._step(st, consts,
                                    self.kkt32 if use32 else None)
                    code = _read(st.status, int)
                    st_iter = _read(st.iter, int)
                dt_step = time.perf_counter() - t0
                timers["step_total"] += dt_step
                if np.isnan(timers["first_chunk"]):
                    timers["first_chunk"] = dt_step
            it = st_iter
            # the reference's device loop returns to the host when a step
            # leaves RUNNING or the chunk's iterations are done
            at_host = (code != RUNNING or it >= chunk_end
                       or (use32 and _read(st.mu, float) <= mu_switch))
            if at_host:
                chunk_end = min(it + chunk, o["max_iter"])
                mu_host = _read(st.mu, float)
                self.host_returns.append(it)
            if code == DEMOTE_F32:
                # precision handover: the same state, f64 step set from here
                f32_demoted = True
                code = RUNNING
                st = st._replace(status=_i32(RUNNING, dev))
                if verbose:
                    say(f"{it:4d}  -- f32 factorization demoted to f64 "
                        f"(mu={float(st.mu):.1e}, rr={float(st.log_rr):.1e},"
                        f" ls={int(st.log_ls)}) --")
                continue
            if code == NEED_RESTORATION:
                if resto_entries < o["resto_max_entries"]:
                    resto_entries += 1
                    if verbose:
                        say(f"{it:4d}  -- feasibility restoration phase "
                            f"(entry {resto_entries}) --")
                    t0 = time.perf_counter()
                    with span("ipm.restore"):
                        st = self._restore(st, consts)
                    code = RUNNING
                    timers["step_total"] += time.perf_counter() - t0
                    continue
                code = STALLED
                st = st._replace(status=_i32(STALLED, dev))
            if verbose:
                say(f"{it:4d} {float(st.log_obj)/float(consts['sf'])* m.sense: .7e} "
                    f"{float(st.log_inf_pr):8.2e} {float(st.log_inf_du):8.2e} "
                    f"{float(st.mu):7.1e} {float(st.log_alpha):6.4f} "
                    f"{float(st.log_alpha_z):6.4f} {int(st.log_ls):3d} "
                    f"{float(st.log_delta_w):7.1e} {float(st.log_rr):7.1e}"
                    f" {float(st.log_E0):7.1e}")
            if at_host and code == RUNNING and (o["recalc_y"]
                                                or o["recalc_y_stall"]):
                # degenerate-ray dual reset (Ipopt recalc_y role): replace
                # multipliers riding a near-null-space ray with the
                # minimal-norm stationarity fit at the current iterate
                tol_h = _read(consts["tol"], float)
                fire = False
                if o["recalc_y"]:
                    fire = (_read(_amax0(torch.abs(st.y)), float)
                            > o["recalc_y_cap"])
                if not fire and o["recalc_y_stall"]:
                    # the terminal crawl creeps the objective upward while
                    # a productive feasible crawl still descends: the sign
                    # of the change separates them
                    obj_now = _read(st.log_obj, float)
                    obj_stalled = (prev_chunk_obj is not None
                                   and obj_now >= prev_chunk_obj
                                   - 1e-5 * max(1.0, abs(obj_now)))
                    prev_chunk_obj = obj_now
                    fire = ((obj_stalled or not o["recalc_y_obj_gate"])
                            and _read(st.log_inf_pr, float) <= 1e2 * tol_h
                            and _read(st.log_inf_du, float) > 1e4 * tol_h
                            and _read(st.log_alpha, float) <= 0.25)
                if fire:
                    st = st._replace(y=self._lsq_duals(st, consts))
                    if verbose:
                        say(f"{it:4d}  -- least-squares dual recalc "
                            f"(du={float(st.log_inf_du):.1e}) --")
            if at_host and checkpoint_path and checkpoint_every and \
                    it // checkpoint_every != \
                    (it - chunk) // checkpoint_every:
                if lead:
                    self.save_checkpoint(checkpoint_path, st)
                if mesh is not None:
                    mesh.barrier()     # written before any rank reads it
            if code != RUNNING:
                status = _STATUS_NAMES[code]
                break
            out_of_time = time.time() - t_start > o["max_wall_time"]
            if mesh is not None and \
                    o["max_wall_time"] < DEFAULTS["max_wall_time"]:
                # a limit was set and the ranks' clocks differ: they stop
                # together when any one is late
                out_of_time = _read(mesh.psum_scalar(torch.as_tensor(
                    float(out_of_time), dtype=m.dtype, device=dev)) > 0)
            if out_of_time:
                status = "max_time"
                break
        solve_time = time.time() - t_start
        # never hand back a WORSE iterate than the best one seen: if the
        # best iterate passes the near-optimal visit gate, report it as
        # "acceptable" (Ipopt: SOLVED_TO_ACCEPTABLE_LEVEL at the limit)
        if status in ("max_iter", "max_time", "stalled"):
            best_E = _read(st.best_E, float)
            gate = (o["acceptable_visit_tol_factor"]
                    * _read(consts["tol"], float))
            if np.isfinite(best_E) and best_E <= gate \
                    and best_E < _read(st.log_E0, float):
                st = st._replace(x=st.best_x, s=st.best_s, y=st.best_y,
                                 zl=st.best_zl, zu=st.best_zu,
                                 log_inf_pr=st.best_inf_pr,
                                 log_inf_du=st.best_inf_du)
                status = "acceptable"
                if verbose:
                    say(f"{it:4d}  -- limit hit: best iterate restored "
                        f"(E={best_E:.1e}) => acceptable --")

        # final dual polish on "acceptable" exits: one least-squares recalc
        # of the multipliers at the returned iterate, kept only if the true
        # dual infeasibility improves
        if status == "acceptable" and (o["recalc_y"] or o["recalc_y_stall"]):
            st_pol = st._replace(y=self._lsq_duals(st, consts))
            du_pol = self._dual_inf(st_pol, consts)
            if _read(du_pol, float) < _read(st.log_inf_du, float):
                st = st_pol._replace(log_inf_du=du_pol)
                if verbose:
                    say(f"{it:4d}  -- dual polish: du -> "
                        f"{float(du_pol):.2e} --")

        n = m.nvar
        sf, sc = consts["sf"], consts["sc"]

        def host(t):
            return t.detach().cpu().numpy()

        res = ExecutionStats(
            status=status,
            objective=_read(m.obj(st.x, consts["theta"]), float),
            solution=host(st.x),
            multipliers=host(st.y * sc / sf * m.sense),
            multipliers_L=host(st.zl[:n] / sf * m.sense),
            multipliers_U=host(st.zu[:n] / sf * m.sense),
            iter=it,
            solve_time=solve_time,
            primal_feas=_read(st.log_inf_pr, float),
            dual_feas=_read(st.log_inf_du, float),
            timers=timers,
        )
        self.results = res
        return res


class MadIpmSolver(IpmSolver):
    """The MadNLP-flavoured alias (the reference's GPU solver entry point,
    ext/InfiniteExaModelsMadNLP.jl): the same algorithm with the structured
    KKT by default."""

    def __init__(self, model, kkt=None, **options):
        options.setdefault("linear_solver", "auto")
        super().__init__(model, kkt=kkt, **options)
