"""InfiniteModel: the user-facing infinite-dimensional model container.

Python equivalent of the InfiniteOpt modeling layer the reference builds on
(layer L5 in SURVEY.md; macro call sites throughout
InfiniteExaModels.jl/examples/).  Holds parameter groups, variables, constraints
and the objective; solving/querying delegates to the attached transformation
backend (layer L4).
"""
from __future__ import annotations

import numpy as np

from .expr import Comparison, as_expr
from .refs import (
    ParameterGroup, InfiniteParameter, FiniteParameter, FiniteVar,
    InfiniteVar, DerivativeRef, SemiInfiniteVar, PointVar,
    ParameterFunctionRef, VarInfo, DomainRestriction,
    UNIFORM_GRID, MC_SAMPLE, USER_DEFINED, PublicLabel,
)
from .sets import IntervalDomain, Distribution, ProductDist
from .derivatives import FiniteDifference


class Infinite:
    """Dependency marker: variable('y', Infinite(t, xi)) (the reference's
    Infinite(t, ξ) variable tag)."""

    def __init__(self, *deps):
        self.deps = deps


MIN = "min"
MAX = "max"


class ConstraintRef:
    __slots__ = ("model", "name", "expr", "lcon", "ucon", "restriction",
                 "groups")

    def __init__(self, model, name, expr, lcon, ucon, restriction, groups):
        self.model = model
        self.name = name
        self.expr = expr
        self.lcon = lcon
        self.ucon = ucon
        self.restriction = restriction
        self.groups = groups

    def __repr__(self):
        return f"ConstraintRef({self.name})"


class InfiniteModel:
    def __init__(self, backend=None, seed=0):
        self.groups = []
        self.finite_params = []
        self.finite_vars = []
        self.infinite_vars = []
        self.pfuncs = []
        self.constraints = []
        self.objective_sense = None
        self.objective_expr = None
        self.piecewise_vars = {}           # gid -> [InfiniteVar]
        self.rng = np.random.default_rng(seed)
        self._deriv_cache = {}             # (id(arg), id(pref), order) -> ref
        self._semi_cache = {}
        self._point_cache = {}
        self._derivs = []                  # creation order
        self._backend = None
        self._name_counter = 0
        if backend is not None:
            self.set_transformation_backend(backend)

    # ------------------------------------------------------------------
    # dirty tracking (the reference's transformation_backend_ready flow,
    # test/solve.jl:157-162, :211-240)
    # ------------------------------------------------------------------
    def _mark_dirty(self):
        if self._backend is not None:
            self._backend.ready = False

    def transformation_backend_ready(self):
        return self._backend is not None and self._backend.ready

    def set_transformation_backend(self, backend):
        self._backend = backend
        backend.attach(self)

    @property
    def backend(self):
        if self._backend is None:
            raise ValueError("no transformation backend attached")
        return self._backend

    def _fresh_name(self, prefix):
        self._name_counter += 1
        return f"{prefix}{self._name_counter}"

    # ------------------------------------------------------------------
    # infinite parameters
    # ------------------------------------------------------------------
    def infinite_parameter(self, name=None, domain=None, dist=None,
                           num_supports=0, dim=None, supports=None,
                           derivative_method=None):
        """Create a scalar infinite parameter (interval domain or univariate
        distribution) or a dependent vector (dim > 1 / multivariate dist /
        list of distributions)."""
        name = name or self._fresh_name("par")
        gid = len(self.groups)
        group = ParameterGroup(gid, self)
        if isinstance(dist, (list, tuple)):
            dist = ProductDist(dist)
        if dist is not None:
            ddim = getattr(dist, "dim", 1)
            if dim is not None and dim != ddim and ddim == 1:
                from .sets import ProductDist as PD

                dist = PD([dist] * dim)
                ddim = dim
            dim = ddim
        dim = dim or 1
        prefs = [InfiniteParameter(group, i,
                                   name if dim == 1 else f"{name}[{i}]")
                 for i in range(dim)]
        group.prefs = prefs
        group.dist = dist
        if derivative_method is not None:
            group.derivative_method = derivative_method
        else:
            group.derivative_method = FiniteDifference()
        if domain is not None:
            if dim != 1:
                raise ValueError("interval domains are scalar-only")
            group.domain = IntervalDomain(*domain)
            if num_supports:
                group.set_supports(group.domain.grid(num_supports),
                                   UNIFORM_GRID)
        elif dist is not None:
            if num_supports:
                samples = dist.sample(self.rng, num_supports)
                if dim == 1:
                    group.set_supports(np.sort(np.atleast_1d(samples)),
                                       MC_SAMPLE)
                else:
                    group.set_supports(np.asarray(samples), MC_SAMPLE)
        else:
            raise ValueError("provide either domain=(lo,hi) or dist=...")
        if supports is not None:
            if group._supports is None:
                group.set_supports(np.asarray(supports, dtype=np.float64),
                                   USER_DEFINED)
            else:
                group.add_supports(supports, USER_DEFINED)
        self.groups.append(group)
        self._mark_dirty()
        return prefs[0] if dim == 1 else prefs

    def add_supports(self, pref, values):
        pref.group.add_supports(values, USER_DEFINED)

    # ------------------------------------------------------------------
    # parameters / variables
    # ------------------------------------------------------------------
    def finite_parameter(self, name=None, value=0.0):
        p = FiniteParameter(self, name or self._fresh_name("fp"), value)
        self.finite_params.append(p)
        self._mark_dirty()
        return p

    def parameter_function(self, fn, deps, name=None):
        groups = self._normalize_deps(deps)
        pf = ParameterFunctionRef(self, name or self._fresh_name("pf"),
                                  fn, groups)
        self.pfuncs.append(pf)
        self._mark_dirty()
        return pf

    def _normalize_deps(self, deps):
        if isinstance(deps, Infinite):
            deps = deps.deps
        if isinstance(deps, InfiniteParameter):
            deps = (deps,)
        groups = []
        for d in deps:
            if isinstance(d, InfiniteParameter):
                g = d.group
            elif isinstance(d, (list, tuple)) and d and \
                    all(isinstance(p, InfiniteParameter) for p in d):
                g = d[0].group
                if len(d) != g.dim or any(p.group is not g for p in d):
                    raise ValueError("dependent parameter vector must be "
                                     "passed whole")
            else:
                raise TypeError(f"bad variable dependency {d!r}")
            groups.append(g)
        gids = [g.gid for g in groups]
        if len(set(gids)) != len(gids):
            raise ValueError("duplicate parameter dependencies")
        if gids != sorted(gids):
            raise ValueError(
                "declare dependencies in parameter creation order (the "
                "transcription tensors follow group-index order)")
        return tuple(groups)

    def variable(self, name=None, deps=(), lb=None, ub=None, start=None,
                 fix=None, binary=False, integer=False):
        if binary or integer:
            # parity with the reference's explicit rejection
            # (transform.jl:41-45)
            raise ValueError(
                "integer variables are not supported by the SIMD core")
        name = name or self._fresh_name("v")
        info = VarInfo(lb=lb, ub=ub, start=start, fix=fix)
        groups = self._normalize_deps(deps)
        if groups:
            v = InfiniteVar(self, name, info, groups)
            self.infinite_vars.append(v)
        else:
            v = FiniteVar(self, name, info)
            self.finite_vars.append(v)
        self._mark_dirty()
        return v

    def variables(self, n, name=None, **kwargs):
        """Convenience: a list of scalar-per-index variables (JuMP's
        x[1:n] container idiom)."""
        base = name or self._fresh_name("v")
        out = []
        for i in range(n):
            kw = {k: (v[i] if isinstance(v, (list, np.ndarray)) else v)
                  for k, v in kwargs.items()}
            out.append(self.variable(name=f"{base}[{i}]", **kw))
        return out

    # -- derivative / restriction caches (dedup like InfiniteOpt) ---------
    def _get_derivative(self, arg, pref, order):
        key = (id(arg), id(pref.group), pref.index, order)
        ref = self._deriv_cache.get(key)
        if ref is None:
            ref = DerivativeRef(self, arg, pref, order)
            self._deriv_cache[key] = ref
            self._derivs.append(ref)
            self._mark_dirty()
        return ref

    def all_derivatives(self):
        return list(self._derivs)

    @staticmethod
    def _fixed_key(fixed):
        return tuple(sorted(
            (gid, tuple(np.atleast_1d(v).tolist())) for gid, v in
            fixed.items()))

    def _register_fixed_supports(self, fixed):
        """Fixing a variable at a support value adds that value to the
        parameter's supports (InfiniteOpt point/semi-infinite semantics: the
        transcription grid must contain the evaluation point)."""
        for gid, val in fixed.items():
            g = self.groups[gid]
            if g.scalar:
                g.add_supports(np.atleast_1d(val), USER_DEFINED)
            else:
                # dependent groups: the value must already be a support row
                supps = g.supports()
                if not np.any(np.all(np.abs(supps - np.asarray(val)) < 1e-12,
                                     axis=1)):
                    raise ValueError(
                        "fixing a dependent parameter vector requires an "
                        "existing support row")

    def _get_semi_infinite(self, parent, fixed):
        key = (id(parent), self._fixed_key(fixed))
        ref = self._semi_cache.get(key)
        if ref is None:
            self._register_fixed_supports(fixed)
            ref = SemiInfiniteVar(self, parent, fixed)
            self._semi_cache[key] = ref
        return ref

    def _get_point(self, parent, values):
        key = (id(parent), self._fixed_key(values))
        ref = self._point_cache.get(key)
        if ref is None:
            self._register_fixed_supports(values)
            ref = PointVar(self, parent, values)
            self._point_cache[key] = ref
        return ref

    # ------------------------------------------------------------------
    # constraints and objective
    # ------------------------------------------------------------------
    def constraint(self, spec, lb=None, ub=None, name=None, restriction=None):
        """Add a constraint from a Comparison (``expr == rhs`` etc.) or from
        an expression with explicit lb/ub (interval form)."""
        from .groups_util import expr_groups

        if isinstance(spec, Comparison):
            expr = spec.lhs - spec.rhs
            if spec.op == "==":
                lcon = ucon = 0.0
            elif spec.op == "<=":
                lcon, ucon = -np.inf, 0.0
            else:
                lcon, ucon = 0.0, np.inf
        else:
            expr = as_expr(spec)
            lcon = -np.inf if lb is None else float(lb)
            ucon = np.inf if ub is None else float(ub)
        if restriction is not None and not isinstance(restriction,
                                                      DomainRestriction):
            raise TypeError("restriction must be a DomainRestriction")
        groups = expr_groups(expr)
        cref = ConstraintRef(self, name or self._fresh_name("c"), expr,
                             lcon, ucon, restriction, groups)
        self.constraints.append(cref)
        self._mark_dirty()
        return cref

    def objective(self, sense, expr):
        from .groups_util import expr_groups

        if sense not in (MIN, MAX):
            raise ValueError("sense must be 'min' or 'max'")
        expr = as_expr(expr)
        if expr_groups(expr):
            raise ValueError(
                "objective is infinite-dimensional; wrap free parameters in "
                "a measure (integral/expect)")
        self.objective_sense = sense
        self.objective_expr = expr
        self._mark_dirty()

    def minimize(self, expr):
        self.objective(MIN, expr)

    def maximize(self, expr):
        self.objective(MAX, expr)

    # ------------------------------------------------------------------
    # solve & query API (delegates to the backend, layer L4)
    # ------------------------------------------------------------------
    def build_transformation_backend(self):
        self.backend.build(self)

    def optimize(self):
        return self.backend.optimize(self)

    def objective_value(self):
        return self.backend.objective_value()

    def value(self, ref, label=PublicLabel):
        return self.backend.map_value(ref, label=label)

    def dual(self, cref, label=PublicLabel):
        return self.backend.map_dual(cref, label=label)

    def supports(self, ref, label=PublicLabel):
        return self.backend.ref_supports(ref, label=label)

    def termination_status(self):
        return self.backend.termination_status()

    def raw_status(self):
        return self.backend.raw_status()

    def solve_time(self):
        return self.backend.solve_time_sec()

    def set_silent(self):
        self.backend.silent = True

    def unset_silent(self):
        self.backend.silent = False

    def set_time_limit_sec(self, v):
        self.backend.time_limit = float(v) if v is not None else np.nan

    def set_attribute(self, name, value):
        self.backend.set_attribute(name, value)

    def get_attribute(self, name):
        return self.backend.get_attribute(name)

    def set_optimizer(self, solver_type, **params):
        self.backend.set_optimizer(solver_type, **params)

    # -- in-place updates (reference infiniteopt_backend.jl:511-592) ------
    def set_parameter_value(self, pref, value):
        if isinstance(pref, FiniteParameter):
            pref.value = float(value)
            if self._backend is None or \
                    not self._backend.update_parameter_value(pref, value):
                self._mark_dirty()
        elif isinstance(pref, ParameterFunctionRef):
            pref.fn = value
            if self._backend is None or \
                    not self._backend.update_parameter_value(pref, value):
                self._mark_dirty()
        else:
            raise TypeError(f"cannot set parameter value of {pref!r}")

    def set_start_value(self, var, value):
        var.info.start = value
        if self._backend is None or \
                not self._backend.update_start_value(var, value):
            self._mark_dirty()

    def warmstart_backend_start_values(self):
        self.backend.warmstart()

    # -- misc introspection ----------------------------------------------
    def num_supports(self, pref, label=PublicLabel):
        from .refs import label_matches

        g = pref.group
        return int(sum(1 for s in g.labels() if label_matches(label, s)))
