"""DSL expression layer for the infinite-dimensional modeling language.

Python operator-overloading equivalent of the JuMP/InfiniteOpt expression
types consumed by the reference's transcription (AffExpr/QuadExpr/
NonlinearExpr dispatch at InfiniteExaModels.jl/src/transform.jl:337-389):
expressions are trees over *model references* (variables, parameters,
parameter functions, measures).  A lightweight quadratic canonicalization
(:class:`QuadForm`) recovers the affine/quadratic structure the reference
gets for free from JuMP, which drives the measure-objective heuristics
(transform.jl:604-767).

Reference leaves use identity hash (usable as dict keys); ``==``/``<=``/
``>=`` build :class:`Comparison` objects for constraint construction.
"""
from __future__ import annotations

import math


class Expr:
    """Base DSL expression; operators build trees, comparisons build
    Comparison specs."""

    __slots__ = ()
    __hash__ = object.__hash__
    __array_priority__ = 100  # beat numpy scalars in mixed ops

    def __add__(self, other):
        return nl("+", self, other)

    def __radd__(self, other):
        return nl("+", other, self)

    def __sub__(self, other):
        return nl("-", self, other)

    def __rsub__(self, other):
        return nl("-", other, self)

    def __mul__(self, other):
        return nl("*", self, other)

    def __rmul__(self, other):
        return nl("*", other, self)

    def __truediv__(self, other):
        return nl("/", self, other)

    def __rtruediv__(self, other):
        return nl("/", other, self)

    def __pow__(self, p):
        # integer powers become multiplication chains (JuMP parity: x^2 is
        # a quadratic term, never a pow call; also avoids pow-AD NaNs at 0)
        if isinstance(p, (int, float)) and float(p).is_integer() \
                and 0 <= p <= 16:
            n = int(p)
            if n == 0:
                return Num(1.0)
            out = self
            for _ in range(n - 1):
                out = nl("*", out, self)
            return out
        return nl("^", self, p)

    def __rpow__(self, other):
        return nl("^", other, self)

    def __neg__(self):
        return nl("neg", self)

    def __pos__(self):
        return self

    def __eq__(self, other):
        return Comparison(self, "==", other)

    def __le__(self, other):
        return Comparison(self, "<=", other)

    def __ge__(self, other):
        return Comparison(self, ">=", other)

    def __lt__(self, other):
        raise TypeError("strict inequalities are not valid constraints")

    __gt__ = __lt__


class Num(Expr):
    __slots__ = ("value",)
    __hash__ = object.__hash__

    def __init__(self, value):
        self.value = float(value)

    def __repr__(self):
        return repr(self.value)


class NLExpr(Expr):
    __slots__ = ("op", "args")
    __hash__ = object.__hash__

    def __init__(self, op, args):
        self.op = op
        self.args = tuple(args)

    def __repr__(self):
        return f"{self.op}({', '.join(map(repr, self.args))})"


def as_expr(obj):
    if isinstance(obj, Expr):
        return obj
    if isinstance(obj, (int, float)):
        return Num(obj)
    # numpy scalars
    try:
        return Num(float(obj))
    except (TypeError, ValueError):
        raise TypeError(f"cannot use {obj!r} in a model expression")


def nl(op, *args):
    try:
        args = [as_expr(a) for a in args]
    except TypeError:
        return NotImplemented
    if all(isinstance(a, Num) for a in args):
        from ..ops.expr import NUMPY_OPS

        fn = NUMPY_OPS.get(op)
        if fn is not None:
            return Num(float(fn(*[a.value for a in args])))
    # keep trees small for the common trivial cases
    if op == "+":
        if isinstance(args[0], Num) and args[0].value == 0.0:
            return args[1]
        if len(args) == 2 and isinstance(args[1], Num) and args[1].value == 0.0:
            return args[0]
    if op == "*" and len(args) == 2:
        for a, b in ((args[0], args[1]), (args[1], args[0])):
            if isinstance(a, Num):
                if a.value == 1.0:
                    return b
                if a.value == 0.0:
                    return Num(0.0)
    return NLExpr(op, args)


class Comparison:
    """A relational spec produced by ==, <=, >= on DSL expressions."""

    __slots__ = ("lhs", "op", "rhs")

    def __init__(self, lhs, op, rhs):
        self.lhs = as_expr(lhs)
        self.op = op
        self.rhs = as_expr(rhs)

    def __bool__(self):
        # identity fallback so dict/set machinery on refs stays safe
        if self.op == "==":
            return self.lhs is self.rhs
        raise TypeError("inequality comparisons of expressions are not "
                        "boolean; wrap them in model.constraint(...)")

    def __repr__(self):
        return f"({self.lhs!r} {self.op} {self.rhs!r})"


# -- math functions over DSL expressions -------------------------------------

def _mk(opname):
    def fn(x):
        if isinstance(x, Expr):
            return nl(opname, x)
        from ..ops.expr import NUMPY_OPS

        return float(NUMPY_OPS[opname](float(x)))

    fn.__name__ = opname
    return fn


sin = _mk("sin")
cos = _mk("cos")
tan = _mk("tan")
asin = _mk("asin")
acos = _mk("acos")
atan = _mk("atan")
sinh = _mk("sinh")
cosh = _mk("cosh")
tanh = _mk("tanh")
exp = _mk("exp")
log = _mk("log")
log2 = _mk("log2")
log10 = _mk("log10")
log1p = _mk("log1p")
sqrt = _mk("sqrt")
cbrt = _mk("cbrt")
abs2 = _mk("abs2")
absval = _mk("abs")


# -- traversal ---------------------------------------------------------------

def iter_refs(expr):
    """Yield every reference leaf (anything that is not Num/NLExpr)."""
    stack = [expr]
    while stack:
        e = stack.pop()
        if isinstance(e, NLExpr):
            stack.extend(e.args)
        elif isinstance(e, Num):
            pass
        else:
            yield e


def all_refs(expr):
    """Unique reference leaves, first-seen order (the reference's
    `all_expression_variables`)."""
    seen, out = set(), []
    for r in iter_refs(expr):
        if id(r) not in seen:
            seen.add(id(r))
            out.append(r)
    return out


def contains_ref(expr, ref):
    return any(r is ref for r in iter_refs(expr))


def map_refs(expr, fn):
    """Rebuild the tree applying fn to every reference leaf (the reference's
    `InfiniteOpt.map_expression`, used at transform.jl:679)."""
    if isinstance(expr, NLExpr):
        return NLExpr(expr.op, [map_refs(a, fn) for a in expr.args])
    if isinstance(expr, Num):
        return expr
    return fn(expr)


# -- quadratic canonicalization ---------------------------------------------


class QuadForm:
    """expr == const + sum_i lin[ref_i]*ref_i + sum_ij quad[(ri,rj)]*ri*rj.

    ``from_expr`` returns None when the expression is not (detectably)
    quadratic -- callers then treat it as general nonlinear, matching the
    reference's type dispatch on JuMP expression classes.
    """

    __slots__ = ("const", "lin", "quad")

    def __init__(self, const=0.0, lin=None, quad=None):
        self.const = const
        self.lin = lin or {}       # {id(ref): (ref, coef)}
        self.quad = quad or {}     # {(id(r1), id(r2)) sorted: (r1, r2, coef)}

    @property
    def is_affine(self):
        return not self.quad

    @property
    def is_constant(self):
        return not self.quad and not self.lin

    def lin_terms(self):
        return [(coef, ref) for (ref, coef) in self.lin.values()]

    def quad_terms(self):
        return [(coef, r1, r2) for (r1, r2, coef) in self.quad.values()]

    def _add(self, other, sign=1.0):
        out = QuadForm(self.const + sign * other.const,
                       dict(self.lin), dict(self.quad))
        for k, (ref, c) in other.lin.items():
            r0, c0 = out.lin.get(k, (ref, 0.0))
            out.lin[k] = (ref, c0 + sign * c)
        for k, (r1, r2, c) in other.quad.items():
            e = out.quad.get(k)
            out.quad[k] = (r1, r2, (e[2] if e else 0.0) + sign * c)
        return out

    def _scale(self, a):
        return QuadForm(
            self.const * a,
            {k: (r, c * a) for k, (r, c) in self.lin.items()},
            {k: (r1, r2, c * a) for k, (r1, r2, c) in self.quad.items()})

    def _mul(self, other):
        if self.quad or other.quad:
            if other.is_constant:
                return self._scale(other.const)
            if self.is_constant:
                return other._scale(self.const)
            return None
        out = QuadForm(self.const * other.const)
        for k, (r, c) in self.lin.items():
            out = out._add(QuadForm(0.0, {k: (r, c * other.const)}))
        for k, (r, c) in other.lin.items():
            out = out._add(QuadForm(0.0, {k: (r, c * self.const)}))
        for ka, (ra, ca) in self.lin.items():
            for kb, (rb, cb) in other.lin.items():
                key = (ka, kb) if ka <= kb else (kb, ka)
                pair = (ra, rb) if ka <= kb else (rb, ra)
                e = out.quad.get(key)
                out.quad[key] = (pair[0], pair[1],
                                 (e[2] if e else 0.0) + ca * cb)
        return out

    @staticmethod
    def from_expr(expr):
        if isinstance(expr, Num):
            return QuadForm(expr.value)
        if not isinstance(expr, NLExpr):   # a reference leaf
            return QuadForm(0.0, {id(expr): (expr, 1.0)})
        op, args = expr.op, expr.args
        if op in ("+", "-") and len(args) == 2:
            a = QuadForm.from_expr(args[0])
            b = QuadForm.from_expr(args[1])
            if a is None or b is None:
                return None
            return a._add(b, 1.0 if op == "+" else -1.0)
        if op == "neg":
            a = QuadForm.from_expr(args[0])
            return None if a is None else a._scale(-1.0)
        if op == "*" and len(args) == 2:
            a = QuadForm.from_expr(args[0])
            b = QuadForm.from_expr(args[1])
            if a is None or b is None:
                return None
            return a._mul(b)
        if op == "/" and len(args) == 2:
            b = QuadForm.from_expr(args[1])
            if b is None or not b.is_constant or b.const == 0.0:
                return None
            a = QuadForm.from_expr(args[0])
            return None if a is None else a._scale(1.0 / b.const)
        if op in ("^", "abs2"):
            a = QuadForm.from_expr(args[0])
            if op == "^":
                p = QuadForm.from_expr(args[1])
                if p is None or not p.is_constant:
                    return None
                if p.const == 1.0:
                    return a
                if p.const != 2.0:
                    return None
            if a is None or a.quad:
                return None
            return a._mul(a)
        return None
