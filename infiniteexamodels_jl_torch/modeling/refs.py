"""Model reference types: parameters, variables, derivatives, measures.

These are the DSL's equivalents of InfiniteOpt's GeneralVariableRef index
types dispatched on by the reference transcription
(InfiniteExaModels.jl/src/transform.jl:290-334): finite variable, infinite
variable, derivative, semi-infinite variable, point variable, infinite
parameter, finite parameter, parameter function, measure.
"""
from __future__ import annotations

import numpy as np

from .expr import Expr
from .derivatives import FiniteDifference

# -- support labels (reference InfiniteOpt label system; consumed by the
#    public/internal filtering at infiniteopt_backend.jl:303-314) -----------

UNIFORM_GRID = "UniformGrid"
MC_SAMPLE = "MCSample"
USER_DEFINED = "UserDefined"
INTERNAL_COLLOCATION = "InternalCollocation"
INTERNAL_QUADRATURE = "InternalQuadrature"

INTERNAL_LABELS = {INTERNAL_COLLOCATION, INTERNAL_QUADRATURE}


class All:
    """Label selector: every support."""


class PublicLabel:
    """Label selector: supports with at least one non-internal label."""


class InternalLabel:
    """Label selector: internal (generative) supports only."""


def label_matches(selector, label_set):
    if selector is All:
        return True
    public = bool(label_set - INTERNAL_LABELS)
    if selector is PublicLabel:
        return public
    if selector is InternalLabel:
        return not public
    raise ValueError(f"unknown label selector {selector!r}")


# -- infinite parameters -----------------------------------------------------


class ParameterGroup:
    """One independent scalar parameter or one dependent parameter vector
    (the reference's parameter groups, transform.jl:9)."""

    def __init__(self, gid, model, prefs=None):
        self.gid = gid
        self.model = model
        self.prefs = prefs or []
        self.domain = None            # IntervalDomain for scalar
        self.dist = None              # Distribution for uncertain params
        self.derivative_method = FiniteDifference()
        self._supports = None         # scalar: (N,) sorted; vector: (N, dim)
        self._labels = []             # list[set[str]] aligned with supports
        self.has_internal = False
        self._generative_done = False
        # Gauss-Legendre node counts requested by integral(...) measures;
        # materialized as internal supports by ensure_generative_supports
        self.quadrature_nodes = set()

    @property
    def dim(self):
        return len(self.prefs)

    @property
    def scalar(self):
        return self.dim == 1

    # -- support management ------------------------------------------------
    def set_supports(self, values, label):
        values = np.asarray(values, dtype=np.float64)
        if self.scalar:
            self._supports = np.zeros(0)
            self._labels = []
            self.add_supports(values, label)
        else:
            if values.ndim != 2 or values.shape[1] != self.dim:
                raise ValueError("dependent supports must be (N, dim)")
            self._supports = values.copy()
            self._labels = [{label} for _ in range(len(values))]

    def add_supports(self, values, label=USER_DEFINED):
        """Merge new scalar supports keeping sorted order; duplicates get the
        extra label.  Adding public supports drops any existing generative
        (internal) nodes -- they are regenerated at the next build so the
        collocation layout stays consistent.

        The result is that of inserting ``values`` one at a time, each
        matched against its sorted neighbours within 1e-12: computed by one
        sort (O(n log n)) wherever the order of insertion cannot change it,
        else one value at a time."""
        if not self.scalar:
            raise ValueError("add_supports on a dependent parameter group")
        values = np.atleast_1d(np.asarray(values, dtype=np.float64))
        if self._supports is None:
            self._supports = np.zeros(0)
            self._labels = []
        merged = self._merge_supports(values, label)
        if merged is None:
            merged = self._insert_supports(values, label)
        supps, labels, inserted = merged
        if inserted and label not in INTERNAL_LABELS and self.has_internal:
            # a genuinely new public support invalidates the generative
            # (collocation) nodes; drop them for regeneration at next build
            keep = [i for i, s in enumerate(labels) if s - INTERNAL_LABELS]
            supps = supps[keep]
            labels = [labels[i] - INTERNAL_LABELS or {label}
                      for i in keep]
            self.has_internal = False
            self._generative_done = False
        self._supports = np.asarray(supps, dtype=np.float64)
        self._labels = labels
        if label in INTERNAL_LABELS:
            self.has_internal = True
        else:
            self._generative_done = self._generative_done and not inserted
        if inserted:
            self.model._mark_dirty()

    def _merge_supports(self, values, label):
        """The insertions as one sort: (supports, labels, inserted?), or
        None where the order of insertion matters.  Old and new values are
        sorted together and cut where neighbours lie 1e-12 or more apart.
        A cluster narrower than 1e-12 holds at most one old support (they
        lie 1e-12 apart); its new values all match that support, or, with
        none, the first of them in input order, which is inserted.  A wider
        cluster (or a NaN) returns None."""
        old = np.asarray(self._supports, dtype=np.float64)
        every = np.concatenate([old, values])
        if np.isnan(every).any() or np.any(np.diff(old) < 1e-12):
            return None
        order = np.argsort(every, kind="stable")
        srt = every[order]
        start = np.ones(len(srt), dtype=bool)
        start[1:] = np.diff(srt) >= 1e-12
        first = np.flatnonzero(start)
        last = np.append(first[1:], len(srt)) - 1
        if np.any(srt[last] - srt[first] >= 1e-12):
            return None
        # each cluster's survivor: its old support, else its first new value
        rep = np.minimum.reduceat(order, first) if len(srt) else order
        sizes = last - first + 1
        labels = []
        for r, k in zip(rep.tolist(), sizes.tolist()):
            if r < len(old):
                lab = self._labels[r]
                if k > 1:
                    lab.add(label)
            else:
                lab = {label}
            labels.append(lab)
        return every[rep], labels, bool(np.any(rep >= len(old)))

    def _insert_supports(self, values, label):
        """The insertions one at a time: (supports, labels, inserted?)."""
        supps = list(self._supports)
        labels = list(self._labels)
        inserted = False
        for v in values:
            pos = int(np.searchsorted(supps, v))
            if pos < len(supps) and abs(supps[pos] - v) < 1e-12:
                labels[pos].add(label)
            elif pos > 0 and abs(supps[pos - 1] - v) < 1e-12:
                labels[pos - 1].add(label)
            else:
                supps.insert(pos, float(v))
                labels.insert(pos, {label})
                inserted = True
        return np.asarray(supps, dtype=np.float64), labels, inserted

    def ensure_generative_supports(self):
        """Add the derivative method's internal nodes (the reference's
        add_generative_supports, transform.jl:22) plus any requested
        Gauss-Legendre quadrature nodes.  Idempotent per build."""
        if not self.scalar or self._generative_done:
            return
        method = self.derivative_method
        if getattr(method, "generative_nodes", 0) > 0:
            public = self.public_supports()
            nodes = method.internal_nodes(public)
            self.add_supports(nodes, INTERNAL_COLLOCATION)
        for k in sorted(self.quadrature_nodes):
            self.add_supports(self.gauss_legendre_points(k)[0],
                              INTERNAL_QUADRATURE)
        self._generative_done = True

    def gauss_legendre_points(self, num_nodes):
        """(nodes, weights) of the num_nodes-point Gauss-Legendre rule
        mapped onto this scalar group's interval domain."""
        if self.domain is None:
            raise ValueError(
                "Gauss-Legendre quadrature requires an interval domain")
        a, b = self.domain.lo, self.domain.hi
        x, w = np.polynomial.legendre.leggauss(int(num_nodes))
        return (a + (x + 1.0) * (b - a) / 2.0), w * (b - a) / 2.0

    def supports(self):
        if self._supports is None:
            raise ValueError(
                f"parameter group {self.gid} has no supports")
        return self._supports

    def labels(self):
        return self._labels

    def num_supports(self):
        return len(self.supports())

    def public_mask(self):
        return np.array([label_matches(PublicLabel, s) for s in self._labels])

    def public_supports(self):
        return self.supports()[self.public_mask()]


class InfiniteParameter(Expr):
    """A scalar infinite parameter (possibly one component of a dependent
    vector)."""

    __slots__ = ("group", "index", "name")
    __hash__ = object.__hash__

    def __init__(self, group, index, name):
        self.group = group
        self.index = index
        self.name = name

    def __repr__(self):
        return self.name

    # convenience passthroughs
    def add_supports(self, values):
        self.group.add_supports(values, USER_DEFINED)

    def set_derivative_method(self, method):
        self.group.derivative_method = method
        self.group._generative_done = False
        self.group.model._mark_dirty()


class FiniteParameter(Expr):
    """Mutable scalar data (the reference's @finite_parameter,
    test/solve.jl:136-140); updated in place without rebuild."""

    __slots__ = ("name", "value", "model")
    __hash__ = object.__hash__

    def __init__(self, model, name, value):
        self.model = model
        self.name = name
        self.value = float(value)

    def __repr__(self):
        return self.name


# -- variable info ----------------------------------------------------------


class VarInfo:
    """Bounds/start/fix; each entry a number, a callable of the support
    values, or None (reference JuMP.VariableInfo handling at
    transform.jl:48-101)."""

    __slots__ = ("lb", "ub", "start", "fix")

    def __init__(self, lb=None, ub=None, start=None, fix=None):
        self.lb = lb
        self.ub = ub
        self.start = start
        self.fix = fix


class VarBase(Expr):
    __slots__ = ()
    __hash__ = object.__hash__

    # JuMP-style bound/start mutation sugar (reference call sites e.g.
    # test/transcription.jl:12-18: set_start_value, delete_lower_bound,
    # set_upper_bound, fix)
    def _touch(self):
        model = getattr(self, "model", None)
        if model is not None:
            model._mark_dirty()

    def set_lower_bound(self, v):
        self.info.lb = v
        self._touch()

    def set_upper_bound(self, v):
        self.info.ub = v
        self._touch()

    def delete_lower_bound(self):
        self.info.lb = -np.inf
        self._touch()

    def delete_upper_bound(self):
        self.info.ub = np.inf
        self._touch()

    def fix(self, v):
        self.info.fix = v
        self._touch()

    def set_start_value(self, v):
        self.info.start = v
        self._touch()


class FiniteVar(VarBase):
    __slots__ = ("model", "name", "info")

    def __init__(self, model, name, info):
        self.model = model
        self.name = name
        self.info = info

    groups = ()

    def __repr__(self):
        return self.name


class InfiniteVar(VarBase):
    __slots__ = ("model", "name", "info", "groups")

    def __init__(self, model, name, info, groups):
        self.model = model
        self.name = name
        self.info = info
        self.groups = tuple(groups)

    def __repr__(self):
        return self.name

    def __call__(self, *args):
        return _restrict(self, args)


class DerivativeRef(VarBase):
    """deriv(argument, pref, order); its own decision tensor over the
    argument's groups plus one defining-equation family (reference
    transform.jl:511-562)."""

    __slots__ = ("model", "argument", "pref", "order", "info")

    def __init__(self, model, argument, pref, order):
        self.model = model
        self.argument = argument
        self.pref = pref
        self.order = order
        self.info = VarInfo()

    @property
    def groups(self):
        return self.argument.groups

    @property
    def name(self):
        return f"d{'' if self.order == 1 else self.order}({self.argument.name},{self.pref.name})"

    def __repr__(self):
        return self.name

    def __call__(self, *args):
        return _restrict(self, args)


class SemiInfiniteVar(VarBase):
    """Parent variable with some groups fixed at given support values
    (reference transform.jl:186-256)."""

    __slots__ = ("model", "parent", "fixed", "info")

    def __init__(self, model, parent, fixed):
        self.model = model
        self.parent = parent
        self.fixed = fixed            # {gid: float | (dim,) array}
        self.info = VarInfo()

    @property
    def groups(self):
        return tuple(g for g in self.parent.groups
                     if g.gid not in self.fixed)

    @property
    def name(self):
        parts = []
        for g in self.parent.groups:
            if g.gid in self.fixed:
                parts.append(str(self.fixed[g.gid]))
            else:
                parts.append(g.prefs[0].name if g.scalar else f"g{g.gid}")
        return f"{self.parent.name}({','.join(parts)})"

    def __repr__(self):
        return self.name

    def __call__(self, *args):
        return _restrict(self, args)


class PointVar(VarBase):
    """Parent variable with every group fixed (reference
    transform.jl:259-287)."""

    __slots__ = ("model", "parent", "values", "info")

    def __init__(self, model, parent, values):
        self.model = model
        self.parent = parent
        self.values = values          # {gid: float | array}
        self.info = VarInfo()

    groups = ()

    @property
    def name(self):
        vals = [str(self.values[g.gid]) for g in self.parent.groups]
        return f"{self.parent.name}({','.join(vals)})"

    def __repr__(self):
        return self.name


class ParameterFunctionRef(VarBase):
    """Known function of infinite parameters, materialized as mutable theta
    data (reference @parameter_function, transform.jl:161-183)."""

    __slots__ = ("model", "name", "fn", "groups")

    def __init__(self, model, name, fn, groups):
        self.model = model
        self.name = name
        self.fn = fn
        self.groups = tuple(groups)

    def __repr__(self):
        return self.name

    def __call__(self, *args):
        return _restrict(self, args)


class MeasureRef(VarBase):
    """A measure (integral / expectation / support sum) over one parameter
    group (reference measure API observed at transform.jl:617-703)."""

    __slots__ = ("model", "expr", "group", "kind", "weight_fn", "method",
                 "num_nodes")

    def __init__(self, model, expr, group, kind, weight_fn=None,
                 method="trapezoid", num_nodes=None):
        self.model = model
        self.expr = expr
        self.group = group
        self.kind = kind              # "integral" | "expect" | "support_sum"
        self.weight_fn = weight_fn
        self.method = method          # "trapezoid" | "gauss_legendre"
        self.num_nodes = num_nodes

    @property
    def groups(self):
        from .groups_util import expr_groups

        inner = expr_groups(self.expr)
        return tuple(g for g in inner if g.gid != self.group.gid)

    @property
    def name(self):
        return f"{self.kind}(..., g{self.group.gid})"

    def __repr__(self):
        return self.name


class DomainRestriction:
    """Restricts a constraint to the sub-domain where ``fn(*support_values)``
    holds (reference DomainRestriction, test/solve.jl:12)."""

    def __init__(self, fn, *prefs):
        self.fn = fn
        self.prefs = tuple(prefs)
        for p in self.prefs:
            if not isinstance(p, InfiniteParameter):
                raise TypeError("DomainRestriction expects infinite parameters")


# -- restriction dispatch ----------------------------------------------------


def _restrict(parent, args):
    """Implement calling a variable-like object with per-group values/prefs:
    numbers fix a group, the group's own prefs keep it free.  Full fixing
    yields a point variable, partial fixing a semi-infinite variable."""
    model = parent.model
    base = parent
    fixed = {}
    if isinstance(parent, SemiInfiniteVar):
        base = parent.parent
        fixed = dict(parent.fixed)
        free_groups = parent.groups
    else:
        free_groups = parent.groups
    if len(args) != len(free_groups):
        raise ValueError(
            f"{parent!r} expects {len(free_groups)} argument(s), got "
            f"{len(args)}")
    for g, a in zip(free_groups, args):
        if isinstance(a, InfiniteParameter):
            if a.group is not g:
                raise ValueError(
                    f"argument {a!r} is not the parameter of group {g.gid}")
            continue
        if isinstance(a, (list, tuple)) and a and \
                all(isinstance(x, InfiniteParameter) for x in a):
            if any(x.group is not g for x in a):
                raise ValueError("mismatched dependent parameter arguments")
            continue
        val = np.asarray(a, dtype=np.float64)
        fixed[g.gid] = float(val) if val.ndim == 0 else val
    if not fixed:
        return parent
    remaining = [g for g in base.groups if g.gid not in fixed]
    if remaining:
        return model._get_semi_infinite(base, fixed)
    return model._get_point(base, fixed)
