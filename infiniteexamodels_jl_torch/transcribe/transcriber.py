"""The transcription compiler: InfiniteModel -> SIMD Core.

Python re-design of the reference's 11-pass compiler
(InfiniteExaModels.jl/src/transform.jl `build_exa_core!`:771-796).  Pass order and
semantics mirror the reference; the output is (template, iterator) families
whose iterators are struct-of-arrays columns instead of Vector{NamedTuple}.

Passes:
 1. base iterators per parameter group (aliases, support->index maps)
 2. finite parameters -> theta entries
 3. finite variables  -> scalar tensors
 4. infinite variables + derivative variables -> dense tensors
    (high-order derivatives lowered to chained first-order ones)
 5. parameter functions -> dense theta tensors
 6. semi-infinite variables -> indexing metadata + bound overrides
 7. point variables -> tensor entries + bound overrides
 8. constraints -> one family per constraint (domain-restriction filtering)
 9. derivative defining equations (FD / orthogonal collocation)
10. collocation restrictions (piecewise-constant controls)
11. objective (measure -> SIMD-sum heuristics with warn fallback)
"""
from __future__ import annotations

import warnings

import numpy as np

from ..ops import Core, Iterator
from ..ops import expr as oex
from ..modeling.expr import Num, NLExpr, all_refs, map_refs, QuadForm
from ..modeling.refs import (
    InfiniteParameter, FiniteParameter, FiniteVar, InfiniteVar,
    DerivativeRef, SemiInfiniteVar, PointVar, ParameterFunctionRef,
    MeasureRef, USER_DEFINED,
)
from ..modeling.measures import measure_coefficients
from ..modeling.derivatives import FiniteDifference, OrthogonalCollocation
from .data import TranscriptionData

OBJ_MEASURE_WARN = (
    "Unable to convert objective measures into a form that is efficient for "
    "the SIMD core using existing heuristics. Performance may be "
    "significantly degraded. Try simplifying the objective structure.")
CON_MEASURE_WARN = (
    "Constrained measures can lead to poor performance with the SIMD core.")


def transcribe(model, dtype=None, device=None, row_pad=1):
    """Build (SimdModel, TranscriptionData) from an InfiniteModel (the
    reference's ExaCore+ExaModel construction, transform.jl:808-839).

    ``row_pad`` pads every family's row axis to a multiple (typically the
    device-mesh size) so sharding never silently falls back to replication."""
    minimize = model.objective_sense != "max"
    core = Core(minimize=minimize)
    data = TranscriptionData()
    t = _Transcriber(model, core, data)
    t.run()
    simd = core.build(dtype=dtype, device=device, row_pad=row_pad)
    return simd, data


class _Transcriber:
    def __init__(self, model, core, data):
        self.model = model
        self.core = core
        self.data = data

    def run(self):
        self.build_base_iterators()
        self.add_finite_parameters()
        self.add_finite_variables()
        self.add_infinite_variables()
        self.add_parameter_functions()
        self.add_semi_infinite_variables()
        self.add_point_variables()
        self.add_constraints()
        self.add_derivative_approximations()
        self.add_collocation_restrictions()
        self.add_objective()

    # ------------------------------------------------------------------
    # pass 1: base iterators
    # ------------------------------------------------------------------
    def build_base_iterators(self):
        d = self.data
        for g in self.model.groups:
            if g.quadrature_nodes and any(
                    dv.pref.group is g
                    for dv in self.model.all_derivatives()):
                warnings.warn(
                    "Gauss-Legendre quadrature adds supports that do not "
                    "align with the derivative grid of this parameter; "
                    "convergence may suffer (use the default trapezoid "
                    "integral for problems with derivatives).")
            g.ensure_generative_supports()
            alias = f"g{g.gid}"
            d.group_alias.append(alias)
            supps = g.supports()
            cols = {alias: np.arange(len(supps))}
            for k, pref in enumerate(g.prefs):
                pa = f"ip{g.gid}" if g.scalar else f"dp{g.gid}_{k}"
                d.param_alias[id(pref)] = pa
                cols[pa] = supps if g.scalar else supps[:, k]
            d.base_itrs.append(Iterator(cols))
            d.support_labels.append(list(g.labels()))
            d.has_internal.append(g.has_internal)
            for i in range(len(supps)):
                d.record_support_index(g.gid, supps[i], i)

    # ------------------------------------------------------------------
    # pass 2-3: finite parameters and variables
    # ------------------------------------------------------------------
    def add_finite_parameters(self):
        for p in self.model.finite_params:
            par = self.core.add_par([p.value], name=p.name)
            self.data._put(self.data.param_map, p, par)

    @staticmethod
    def _scalar_info(info):
        lb, ub, start = -np.inf, np.inf, 0.0
        if info.fix is not None:
            lb = ub = float(info.fix)
        if info.lb is not None:
            lb = float(info.lb)
        if info.ub is not None:
            ub = float(info.ub)
        if info.start is not None:
            start = float(info.start)
        return lb, ub, start

    def add_finite_variables(self):
        for v in self.model.finite_vars:
            lb, ub, start = self._scalar_info(v.info)
            var = self.core.add_var((), lvar=lb, uvar=ub, start=start,
                                    name=v.name)
            self.data._put(self.data.finvar_map, v, var.entry())

    # ------------------------------------------------------------------
    # pass 4: infinite variables + derivatives
    # ------------------------------------------------------------------
    def _eval_over_grid(self, fn, groups):
        """Evaluate a callable over the support product grid of ``groups``
        (reference _get_variable_bounds_and_start, transform.jl:76-101).
        Scalar groups contribute a float argument, vector groups an array."""
        dims = tuple(g.num_supports() for g in groups)
        out = np.empty(dims)
        grids = [g.supports() for g in groups]
        for idx in np.ndindex(*dims):
            args = [grid[i] for grid, i in zip(grids, idx)]
            out[idx] = fn(*args)
        return out

    def _array_info(self, info, groups):
        dims = tuple(g.num_supports() for g in groups)

        def build(v, default):
            if v is None:
                return None
            if callable(v):
                return self._eval_over_grid(v, groups)
            return np.broadcast_to(np.asarray(v, dtype=np.float64),
                                   dims).copy()

        lb = build(info.lb, -np.inf)
        ub = build(info.ub, np.inf)
        start = build(info.start, 0.0)
        fix = build(info.fix, None)
        L = np.full(dims, -np.inf) if lb is None else lb
        U = np.full(dims, np.inf) if ub is None else ub
        S = np.zeros(dims) if start is None else start
        if fix is not None:
            L, U = fix.copy(), fix.copy()
        return L, U, S

    def _expanded_derivatives(self):
        """All derivative refs with high-order ones lowered to chains of
        first-order derivatives (reference
        reformulate_high_order_derivatives!, transform.jl:141).  Returns
        [(dref, defining_argument_ref)]."""
        model = self.model
        out = []
        i = 0
        # iterating while the cache-backed list may grow
        while i < len(model._derivs):
            dref = model._derivs[i]
            i += 1
            if dref.order == 1:
                out.append((dref, dref.argument))
            else:
                lower = model._get_derivative(dref.argument, dref.pref,
                                              dref.order - 1)
                out.append((dref, lower))
        # deduplicate (chain creation may have revisited entries)
        seen, uniq = set(), []
        for dref, arg in out:
            if id(dref) not in seen:
                seen.add(id(dref))
                uniq.append((dref, arg))
        return uniq

    def add_infinite_variables(self):
        self._deriv_pairs = self._expanded_derivatives()
        all_vars = list(self.model.infinite_vars) + \
            [d for d, _ in self._deriv_pairs]
        for v in all_vars:
            groups = v.groups
            dims = tuple(g.num_supports() for g in groups)
            L, U, S = self._array_info(v.info, groups)
            var = self.core.add_var(dims, lvar=L, uvar=U, start=S,
                                    name=v.name)
            self.data._put(self.data.infvar_map, v, var)

    # ------------------------------------------------------------------
    # pass 5: parameter functions
    # ------------------------------------------------------------------
    def add_parameter_functions(self):
        for pf in self.model.pfuncs:
            vals = self._eval_over_grid(pf.fn, pf.groups)
            par = self.core.add_par(vals, name=pf.name)
            self.data._put(self.data.param_map, pf, par)

    # ------------------------------------------------------------------
    # pass 6-7: semi-infinite and point variables
    # ------------------------------------------------------------------
    def _process_semi_infinite(self, ref):
        """Compute (mapped ops object, indexing) where indexing mixes fixed
        support ints and free group aliases (reference
        _process_semi_infinite_var, transform.jl:186-213)."""
        d = self.data
        parent = ref.parent
        if isinstance(parent, ParameterFunctionRef):
            mapped = d._get(d.param_map, parent)
        else:
            mapped = d._get(d.infvar_map, parent)
        if mapped is None:
            raise KeyError(f"parent of {ref!r} not transcribed")
        indexing = []
        for g in parent.groups:
            if g.gid in ref.fixed:
                indexing.append(d.support_index(g.gid, ref.fixed[g.gid]))
            else:
                indexing.append(d.group_alias[g.gid])
        d._put(d.semivar_info, ref, (mapped, indexing))
        return mapped, indexing

    def add_semi_infinite_variables(self):
        d = self.data
        for ref in self.model._semi_cache.values():
            mapped, indexing = self._process_semi_infinite(ref)
            info = ref.info
            if any(v is not None for v in
                   (info.lb, info.ub, info.start, info.fix)):
                self._apply_override_slice(mapped, indexing, info)

    def _apply_override_slice(self, var, indexing, info):
        """In-place bound/start overrides on a tensor slice (reference
        _update_bounds_and_start, transform.jl:216-231)."""
        spans = [range(var.shape[i]) if not isinstance(ix, int) else [ix]
                 for i, ix in enumerate(indexing)]
        import itertools

        for idx in itertools.product(*spans):
            entry = var[idx]
            self.core.set_bounds_entry(
                entry,
                lvar=(info.fix if info.fix is not None else info.lb),
                uvar=(info.fix if info.fix is not None else info.ub),
                start=info.start)

    def _process_point(self, ref):
        d = self.data
        parent = ref.parent
        if isinstance(parent, ParameterFunctionRef):
            # fully-evaluated parameter function: a plain number
            args = [ref.values[g.gid] for g in parent.groups]
            return float(parent.fn(*args))
        var = d._get(d.infvar_map, parent)
        idxs = tuple(d.support_index(g.gid, ref.values[g.gid])
                     for g in parent.groups)
        entry = var[idxs]
        d._put(d.finvar_map, ref, entry)
        return entry

    def add_point_variables(self):
        for ref in self.model._point_cache.values():
            entry = self._process_point(ref)
            if isinstance(entry, float):
                continue
            info = ref.info
            if any(v is not None for v in
                   (info.lb, info.ub, info.start, info.fix)):
                self.core.set_bounds_entry(
                    entry,
                    lvar=(info.fix if info.fix is not None else info.lb),
                    uvar=(info.fix if info.fix is not None else info.ub),
                    start=info.start)

    # ------------------------------------------------------------------
    # exafication: DSL expression -> SIMD template
    # ------------------------------------------------------------------
    def exafy(self, expr):
        d = self.data
        if isinstance(expr, Num):
            return oex.Const(expr.value)
        if isinstance(expr, NLExpr):
            return oex.apply_op(expr.op, *[self.exafy(a) for a in expr.args])
        if isinstance(expr, FiniteVar):
            return d._get(d.finvar_map, expr)
        if isinstance(expr, PointVar):
            entry = d._get(d.finvar_map, expr)
            if entry is None:
                entry = self._process_point(expr)
            if isinstance(entry, float):
                return oex.Const(entry)
            return entry
        if isinstance(expr, (InfiniteVar, DerivativeRef)):
            var = d._get(d.infvar_map, expr)
            if var is None:
                raise KeyError(f"{expr!r} was not transcribed (was it "
                               "created after the build?)")
            idx = tuple(oex.FieldRef(d.group_alias[g.gid])
                        for g in expr.groups)
            return var[idx]
        if isinstance(expr, SemiInfiniteVar):
            got = d._get(d.semivar_info, expr)
            if got is None:
                got = self._process_semi_infinite(expr)
            mapped, indexing = got
            idx = tuple(ix if isinstance(ix, int) else oex.FieldRef(ix)
                        for ix in indexing)
            return mapped[idx]
        if isinstance(expr, InfiniteParameter):
            return oex.FieldRef(d.param_alias[id(expr)])
        if isinstance(expr, FiniteParameter):
            par = d._get(d.param_map, expr)
            return par[(0,)] if par.shape else par.entry()
        if isinstance(expr, ParameterFunctionRef):
            par = d._get(d.param_map, expr)
            idx = tuple(oex.FieldRef(d.group_alias[g.gid])
                        for g in expr.groups)
            return par[idx]
        if isinstance(expr, MeasureRef):
            raise TypeError(
                "measures must be expanded before exafication")
        raise TypeError(f"cannot transcribe expression leaf {expr!r}")

    # ------------------------------------------------------------------
    # measure expansion (reference InfiniteOpt.expand_measures fallback)
    # ------------------------------------------------------------------
    def expand_measures(self, expr):
        def visit(e):
            if isinstance(e, NLExpr):
                return NLExpr(e.op, [visit(a) for a in e.args])
            if isinstance(e, MeasureRef):
                return self._expand_measure(e)
            return e

        return visit(expr)

    def _expand_measure(self, mref):
        g = mref.group
        idxs, coeffs = measure_coefficients(mref)
        supps = g.supports()
        inner = self.expand_measures(mref.expr)
        total = Num(0.0)
        for i, c in zip(idxs, coeffs):
            val = supps[i]
            term = self._fix_group(inner, g, val)
            total = total + float(c) * term
        return total

    def _fix_group(self, expr, g, val):
        """Substitute group g at support value ``val`` throughout an
        expression (creating point/semi-infinite restrictions)."""
        model = self.model

        def fix_ref(r):
            if isinstance(r, InfiniteParameter) and r.group is g:
                v = val if g.scalar else val[r.index]
                return Num(float(v))
            if isinstance(r, (InfiniteVar, DerivativeRef,
                              ParameterFunctionRef)):
                if g in r.groups:
                    return self._restrict_ref(r, {g.gid: val})
                return r
            if isinstance(r, SemiInfiniteVar):
                if g in r.groups:
                    fixed = dict(r.fixed)
                    fixed[g.gid] = val
                    return self._restrict_ref(r.parent, fixed)
                return r
            if isinstance(r, MeasureRef):
                raise TypeError("nested measure must be expanded first")
            return r

        return map_refs(expr, fix_ref)

    def _restrict_ref(self, base, fixed):
        remaining = [g2 for g2 in base.groups if g2.gid not in fixed]
        if isinstance(base, ParameterFunctionRef) and not remaining:
            args = [fixed[g2.gid] for g2 in base.groups]
            return Num(float(base.fn(*args)))
        if remaining:
            return self.model._get_semi_infinite(base, fixed)
        return self.model._get_point(base, fixed)

    # ------------------------------------------------------------------
    # pass 8: constraints
    # ------------------------------------------------------------------
    def _constraint_iterator(self, groups):
        d = self.data
        if not groups:
            return Iterator.single()
        if len(groups) == 1:
            return d.base_itrs[groups[0].gid].copy()
        return Iterator.product(*[d.base_itrs[g.gid] for g in groups])

    def _apply_restriction(self, itr, restriction):
        d = self.data
        cols = [itr[d.param_alias[id(p)]] for p in restriction.prefs]
        mask = np.fromiter(
            (bool(restriction.fn(*vals)) for vals in zip(*cols)),
            dtype=bool, count=len(itr))
        return itr.select(mask)

    def add_constraints(self):
        from ..modeling.groups_util import expr_groups

        for cref in self.model.constraints:
            expr = cref.expr
            if any(isinstance(r, MeasureRef) for r in all_refs(expr)):
                warnings.warn(CON_MEASURE_WARN)
                expr = self.expand_measures(expr)
            groups = expr_groups(expr)
            itr = self._constraint_iterator(groups)
            if cref.restriction is not None:
                itr = self._apply_restriction(itr, cref.restriction)
            template = _finalize(self.exafy(expr))
            fam = self.core.add_con(template, itr, lcon=cref.lcon,
                                    ucon=cref.ucon, name=cref.name)
            self.data._put(self.data.con_map, cref, fam)

    # ------------------------------------------------------------------
    # pass 9: derivative defining equations
    # ------------------------------------------------------------------
    def _indexed_entry(self, ref, pref_group, idx_field):
        """Template entry for ``ref`` with the pref group's axis indexed by
        ``idx_field`` and all other axes by their group aliases (reference
        make_reduced_expr extension, transform.jl:471-508)."""
        d = self.data
        if isinstance(ref, SemiInfiniteVar):
            got = d._get(d.semivar_info, ref)
            if got is None:
                got = self._process_semi_infinite(ref)
            mapped, indexing = got
            alias = d.group_alias[pref_group.gid]
            idx = tuple(
                ix if isinstance(ix, int)
                else (idx_field if ix == alias else oex.FieldRef(ix))
                for ix in indexing)
            return mapped[idx]
        var = d._get(d.infvar_map, ref)
        idx = tuple(
            idx_field if g.gid == pref_group.gid
            else oex.FieldRef(d.group_alias[g.gid])
            for g in ref.groups)
        return var[idx]

    def add_derivative_approximations(self):
        d = self.data
        for dref, argref in self._deriv_pairs:
            g = dref.pref.group
            method = g.derivative_method
            supps = g.supports()
            if isinstance(method, FiniteDifference):
                rows, icols, fcols = method.stencil(supps)
                itr_cols = {d.group_alias[g.gid]: rows,
                            d.param_alias[id(dref.pref)]: supps[rows]}
                for k, v in icols.items():
                    itr_cols[k] = v
                for k, v in fcols.items():
                    itr_cols[k] = v
                pref_itr = Iterator(itr_cols)
                dvar_e = self._indexed_entry(
                    dref, g, oex.IdxAff({d.group_alias[g.gid]: 1}))
                ya = self._indexed_entry(argref, g, oex.IdxAff({"a": 1}))
                yb = self._indexed_entry(argref, g, oex.IdxAff({"b": 1}))
                template = dvar_e * oex.FieldRef("h") - (ya - yb)
            elif isinstance(method, OrthogonalCollocation):
                rows, icols, fcols = method.stencil(supps)
                itr_cols = {d.group_alias[g.gid]: rows,
                            d.param_alias[id(dref.pref)]: supps[rows]}
                for k, v in icols.items():
                    itr_cols[k] = v
                for k, v in fcols.items():
                    itr_cols[k] = v
                pref_itr = Iterator(itr_cols)
                ya = self._indexed_entry(argref, g, oex.IdxAff({"a": 1}))
                yb = self._indexed_entry(argref, g, oex.IdxAff({"b": 1}))
                acc = ya - yb
                for k in range(method.n):
                    dk = self._indexed_entry(
                        dref, g, oex.IdxAff({f"c{k}": 1}))
                    acc = acc - oex.FieldRef(f"w{k}") * dk
                template = acc
            else:
                raise ValueError(f"unknown derivative method {method!r}")
            other = [g2 for g2 in dref.groups if g2.gid != g.gid]
            if other:
                itr = Iterator.product(
                    pref_itr, *[d.base_itrs[g2.gid] for g2 in other])
            else:
                itr = pref_itr
            fam = self.core.add_con(template, itr, lcon=0.0, ucon=0.0,
                                    name=f"def_{dref.name}")
            d._put(d.deriv_con_map, dref, fam)

    # ------------------------------------------------------------------
    # pass 10: collocation restrictions
    # ------------------------------------------------------------------
    def add_collocation_restrictions(self):
        d = self.data
        for gid, vars_ in self.model.piecewise_vars.items():
            g = self.model.groups[gid]
            method = g.derivative_method
            k = getattr(method, "generative_nodes", 0)
            if k <= 0:
                continue
            n = method.n
            nsupp = g.num_supports()
            nel = (nsupp - 1) // (n - 1)
            i1, i2 = [], []
            for e in range(nel):
                base = e * (n - 1)
                right = base + n - 1
                for j in range(1, n - 1):
                    i1.append(right)
                    i2.append(base + j)
            pref_itr = Iterator({"i1": np.asarray(i1), "i2": np.asarray(i2)})
            for v in vars_:
                var = d._get(d.infvar_map, v)
                other = [g2 for g2 in v.groups if g2.gid != gid]
                itr = Iterator.product(
                    pref_itr, *[d.base_itrs[g2.gid] for g2 in other]) \
                    if other else pref_itr

                def entry(field):
                    idx = tuple(
                        oex.IdxAff({field: 1}) if g2.gid == gid
                        else oex.FieldRef(d.group_alias[g2.gid])
                        for g2 in v.groups)
                    return var[idx]

                template = entry("i1") - entry("i2")
                self.core.add_con(template, itr, lcon=0.0, ucon=0.0,
                                  name=f"coll_{v.name}")

    # ------------------------------------------------------------------
    # pass 11: objective
    # ------------------------------------------------------------------
    def _measure_iterator(self, mref, prev=None):
        """Iterator with coefficient column 'c' for one measure, optionally
        producted with an enclosing measure's iterator (reference
        _make_measure_itr + _process_measure_sum nesting,
        transform.jl:618-686)."""
        d = self.data
        g = mref.group
        idxs, coeffs = measure_coefficients(mref)
        supps = g.supports()
        cols = {d.group_alias[g.gid]: idxs}
        for k, pref in enumerate(g.prefs):
            pa = d.param_alias[id(pref)]
            cols[pa] = supps[idxs] if g.scalar else supps[idxs, k]
        cur = Iterator(cols)
        cur_c = coeffs
        if prev is None:
            cur["c"] = cur_c
            return cur
        prev_c = prev["c"]
        rest_prev = Iterator({k: v for k, v in prev.columns.items()
                              if k != "c"})
        merged = Iterator.product(cur, rest_prev)
        # product is C-order with the LAST iterator fastest
        cprod = np.repeat(cur_c, len(rest_prev)) * \
            np.tile(prev_c, len(cur))
        merged["c"] = cprod
        return merged

    def _movable_inside(self, expr, mref):
        """Reference _terms_can_be_moved_inside_measure
        (transform.jl:642-660)."""
        if expr is mref:
            return True
        if not isinstance(expr, NLExpr):
            return True  # refs and numbers
        qf = QuadForm.from_expr(expr)
        if qf is not None:
            if qf.is_affine:
                return True
            return all(not (r1 is mref and r2 is mref)
                       for _, r1, r2 in qf.quad_terms())
        from ..modeling.expr import contains_ref

        m_args = [a for a in expr.args if contains_ref(a, mref)]
        if expr.op in ("+", "-"):
            return all(self._movable_inside(a, mref) for a in m_args)
        if expr.op == "*":
            if len(m_args) != 1:
                return False
            return self._movable_inside(m_args[0], mref)
        return False

    def _process_measure_sum(self, mref, prev_itr=None):
        itr = self._measure_iterator(mref, prev_itr)
        mexpr = mref.expr
        mrefs = [r for r in all_refs(mexpr) if isinstance(r, MeasureRef)]
        if not mrefs:
            return mexpr, itr
        if len(mrefs) == 1 and self._movable_inside(mexpr, mrefs[0]):
            inner, new_itr = self._process_measure_sum(mrefs[0], itr)
            out = map_refs(mexpr,
                           lambda r: inner if r is mrefs[0] else r)
            return out, new_itr
        warnings.warn(OBJ_MEASURE_WARN)
        return self.expand_measures(mexpr), itr

    def _add_measure_term(self, coef, mref):
        """coef may be a float or a finite DSL expression (reference
        _add_objective_aff_term for MeasureIndex, transform.jl:693-702)."""
        mexpr, itr = self._process_measure_sum(mref)
        full = coef * mexpr if not (isinstance(coef, float) and coef == 1.0) \
            else mexpr
        template = oex.FieldRef("c") * self.exafy(full)
        self.core.add_obj(_finalize(template), itr, name="obj_measure")

    def _add_generic_term(self, expr):
        template = _finalize(self.exafy(expr))
        self.core.add_obj(template, Iterator.single(), name="obj_term")

    def add_objective(self):
        expr = self.model.objective_expr
        if expr is None:
            return
        if isinstance(expr, MeasureRef):
            self._add_measure_term(1.0, expr)
            return
        if isinstance(expr, Num):
            if expr.value != 0.0:
                self.core.add_obj(oex.Const(expr.value), Iterator.single())
            return
        if not isinstance(expr, NLExpr):
            # single non-measure ref (finite var, point var, finite param)
            self._add_generic_term(expr)
            return
        qf = QuadForm.from_expr(expr)
        if qf is None:
            # general nonlinear objective: warn if it holds measures, expand
            if any(isinstance(r, MeasureRef) for r in all_refs(expr)):
                warnings.warn(OBJ_MEASURE_WARN)
            self._add_generic_term(self.expand_measures(expr))
            return
        # quadratic terms (reference transform.jl:745-767)
        for coef, r1, r2 in qf.quad_terms():
            m1 = isinstance(r1, MeasureRef)
            m2 = isinstance(r2, MeasureRef)
            if m1 and m2:
                warnings.warn(OBJ_MEASURE_WARN)
                prod = coef * self.expand_measures(
                    NLExpr("*", (r1, r2)))
                self._add_generic_term(prod)
            elif m1:
                self._add_measure_term(coef * r2, r1)
            elif m2:
                self._add_measure_term(coef * r1, r2)
            else:
                self._add_generic_term(coef * NLExpr("*", (r1, r2)))
        # affine terms (reference transform.jl:729-744)
        for coef, ref in qf.lin_terms():
            if coef == 0.0:
                continue
            if isinstance(ref, MeasureRef):
                self._add_measure_term(float(coef), ref)
            else:
                self._add_generic_term(coef * ref)
        if qf.const != 0.0:
            self.core.add_obj(oex.Const(qf.const), Iterator.single())


def _finalize(template):
    """Constants must still form a valid family (reference
    ExaModels.Null, transform.jl:392-393)."""
    if isinstance(template, (int, float)):
        return oex.Const(template)
    return template
