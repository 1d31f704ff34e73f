"""Symbolic expression templates for the SIMD NLP core.

The core abstraction (mirroring the capability of ExaModels.jl's expression
templates, reference upstream usage at InfiniteExaModels.jl/src/transform.jl:453-458):
every objective/constraint *family* is a single algebraic template evaluated
over an iterator of rows.  A template is a small expression tree whose leaves
are

- :class:`Const`      -- literal numbers,
- :class:`FieldRef`   -- a float data column of the iterator (support values,
                         quadrature coefficients, ...),
- :class:`VarEntry`   -- an entry of a variable tensor, indexed by integer
                         affine expressions of iterator index columns,
- :class:`ParamEntry` -- an entry of a parameter (theta) tensor, indexed the
                         same way.

Because the iterator columns are concrete (numpy) data at build time, all
variable/parameter indices are *static*: a family compiles to one PyTorch
function of gathered values that is vmapped over rows, which is exactly the SIMD
property that makes the sparsity pattern identical per row.
"""
from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# Integer affine index expressions
# ---------------------------------------------------------------------------


class IdxAff:
    """Integer affine expression ``sum(coef * column) + const`` over iterator
    integer columns.  Used to index variable/parameter tensors inside
    templates, e.g. ``x[i - 1]`` for a backward difference stencil."""

    __slots__ = ("terms", "const")

    def __init__(self, terms=None, const=0):
        self.terms = dict(terms or {})
        self.const = int(const)

    def key(self):
        return ("idx", tuple(sorted(self.terms.items())), self.const)

    # -- arithmetic (int only) ------------------------------------------
    def __add__(self, other):
        if isinstance(other, IdxAff):
            t = dict(self.terms)
            for k, v in other.terms.items():
                t[k] = t.get(k, 0) + v
            return IdxAff(t, self.const + other.const)
        if isinstance(other, int):
            return IdxAff(self.terms, self.const + other)
        return NotImplemented

    __radd__ = __add__

    def __neg__(self):
        return IdxAff({k: -v for k, v in self.terms.items()}, -self.const)

    def __sub__(self, other):
        if isinstance(other, (IdxAff, int)):
            return self + (-other if isinstance(other, IdxAff) else -other)
        return NotImplemented

    def __rsub__(self, other):
        if isinstance(other, int):
            return (-self) + other
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, int):
            return IdxAff({k: v * other for k, v in self.terms.items()},
                          self.const * other)
        return NotImplemented

    __rmul__ = __mul__

    def evaluate(self, columns):
        """Evaluate against a dict of numpy integer columns."""
        out = self.const
        for name, coef in self.terms.items():
            out = out + coef * columns[name]
        return out

    def __repr__(self):
        parts = [f"{c}*{n}" if c != 1 else n for n, c in self.terms.items()]
        if self.const or not parts:
            parts.append(str(self.const))
        return "+".join(parts)


def as_index(obj):
    """Coerce an object used inside ``var[...]`` to ``int | IdxAff``.

    Accepts ints, IdxAff, FieldRef, and integer-affine Call trees built by
    operator overloading (``src.i - 1`` parses as a Call before we know it is
    used as an index)."""
    if isinstance(obj, (int,)):
        return int(obj)
    if isinstance(obj, IdxAff):
        return obj
    if isinstance(obj, FieldRef):
        return IdxAff({obj.name: 1}, 0)
    if isinstance(obj, (Const, Call)):
        aff = _expr_to_idxaff(obj)
        if aff is not None:
            return aff
    raise TypeError(f"cannot use {obj!r} as a tensor index")


def _expr_to_idxaff(node):
    """Convert an integer-affine expression tree to IdxAff, or None."""
    if isinstance(node, Const):
        if float(node.value).is_integer():
            return IdxAff({}, int(node.value))
        return None
    if isinstance(node, FieldRef):
        return IdxAff({node.name: 1}, 0)
    if isinstance(node, Call):
        args = [_expr_to_idxaff(a) for a in node.args]
        if any(a is None for a in args):
            return None
        if node.op == "+":
            out = args[0]
            for a in args[1:]:
                out = out + a
            return out
        if node.op == "-" and len(args) == 2:
            return args[0] - args[1]
        if node.op == "neg":
            return -args[0]
        if node.op == "*" and len(args) == 2:
            for a, b in ((args[0], args[1]), (args[1], args[0])):
                if not a.terms:  # pure constant factor
                    return b * a.const
            return None
        return None
    return None


def _index_key(idx):
    return idx.key() if isinstance(idx, IdxAff) else ("i", idx)


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


class Expr:
    """Base class for template expression nodes; operator overloads build the
    tree.  Numeric python scalars are auto-lifted to :class:`Const`."""

    __slots__ = ()

    # every subclass defines .key() (structural identity) and .children

    def __add__(self, other):
        return _call("+", self, other)

    def __radd__(self, other):
        return _call("+", other, self)

    def __sub__(self, other):
        return _call("-", self, other)

    def __rsub__(self, other):
        return _call("-", other, self)

    def __mul__(self, other):
        return _call("*", self, other)

    def __rmul__(self, other):
        return _call("*", other, self)

    def __truediv__(self, other):
        return _call("/", self, other)

    def __rtruediv__(self, other):
        return _call("/", other, self)

    def __pow__(self, other):
        if isinstance(other, (int, float)) and other == 2:
            return _call("abs2", self)
        return _call("^", self, other)

    def __rpow__(self, other):
        return _call("^", other, self)

    def __neg__(self):
        return _call("neg", self)

    def __pos__(self):
        return self

    # comparisons build constraint specs (used by the modeling layer through
    # its own expression type; the ops layer keeps templates pure)


def lift(obj):
    if isinstance(obj, Expr):
        return obj
    if isinstance(obj, (int, float)):
        return Const(float(obj))
    if isinstance(obj, IdxAff):
        # an affine combo of integer columns used as a value
        e = Const(float(obj.const))
        for name, coef in obj.terms.items():
            e = e + float(coef) * FieldRef(name)
        return e
    raise TypeError(f"cannot use {obj!r} in a template expression")


class Const(Expr):
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = float(value)

    def key(self):
        return ("c", self.value)

    children = ()

    def __repr__(self):
        return repr(self.value)


class FieldRef(Expr):
    """Float data column of the iterator (by name)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def key(self):
        return ("f", self.name)

    children = ()

    def __repr__(self):
        return f"${self.name}"


class VarEntry(Expr):
    """One scalar entry of a variable tensor: ``var[idx...]`` where each index
    is an int or IdxAff over iterator columns.  ``.i`` (flat index) is defined
    for constant indices, mirroring ExaModels.Var handles
    (reference InfiniteExaModels.jl/src/infiniteopt_backend.jl:560)."""

    __slots__ = ("var", "idx")

    def __init__(self, var, idx):
        self.var = var
        self.idx = tuple(as_index(i) for i in idx)

    def key(self):
        return ("v", self.var.vid, tuple(_index_key(i) for i in self.idx))

    children = ()

    @property
    def is_static(self):
        return all(isinstance(i, int) for i in self.idx)

    @property
    def i(self):
        """Flat index into x for a statically-indexed entry."""
        if not self.is_static:
            raise ValueError("entry has iterator-dependent indices")
        return self.var.flat_index(self.idx)

    def __repr__(self):
        return f"{self.var.name}[{','.join(map(repr, self.idx))}]"


class ParamEntry(Expr):
    __slots__ = ("param", "idx")

    def __init__(self, param, idx):
        self.param = param
        self.idx = tuple(as_index(i) for i in idx)

    def key(self):
        return ("p", self.param.pid, tuple(_index_key(i) for i in self.idx))

    children = ()

    @property
    def is_static(self):
        return all(isinstance(i, int) for i in self.idx)

    @property
    def i(self):
        if not self.is_static:
            raise ValueError("entry has iterator-dependent indices")
        return self.param.flat_index(self.idx)

    def __repr__(self):
        return f"{self.param.name}[{','.join(map(repr, self.idx))}]"


class Call(Expr):
    __slots__ = ("op", "args", "_key")

    def __init__(self, op, args):
        self.op = op
        self.args = tuple(args)
        self._key = None

    def key(self):
        if self._key is None:
            self._key = (self.op,) + tuple(a.key() for a in self.args)
        return self._key

    @property
    def children(self):
        return self.args

    def __repr__(self):
        return f"{self.op}({', '.join(map(repr, self.args))})"


def _int_pow(base, n):
    """x**n for integer n as a multiplication chain (exponentiation by
    squaring).  Avoids the power function's exp/log path, whose AD can
    produce NaN at x == 0 (the Hessian of u**2.0 at u=0 evaluates 0**0
    through exp(0*log(0)) on some backends)."""
    if n == 0:
        return Const(1.0)
    if n < 0:
        return _call("inv", _int_pow(base, -n))
    result = None
    sq = base
    while n:
        if n & 1:
            result = sq if result is None else _call("*", result, sq)
        n >>= 1
        if n:
            sq = _call("*", sq, sq)
    return result


def _call(op, *args):
    try:
        args = [lift(a) for a in args]
    except TypeError:
        return NotImplemented
    if op == "^" and len(args) == 2 and isinstance(args[1], Const) \
            and float(args[1].value).is_integer() \
            and abs(args[1].value) <= 16:
        return _int_pow(args[0], int(args[1].value))
    # constant folding keeps template size down for big summations
    if all(isinstance(a, Const) for a in args):
        import numpy as _np

        fn = NUMPY_OPS.get(op)
        if fn is not None:
            return Const(float(fn(*[a.value for a in args])))
    # trivial simplifications
    if op == "+" and isinstance(args[0], Const) and args[0].value == 0.0:
        return args[1]
    if op == "+" and len(args) == 2 and isinstance(args[1], Const) and args[1].value == 0.0:
        return args[0]
    if op == "*" and isinstance(args[0], Const):
        if args[0].value == 1.0:
            return args[1]
        if args[0].value == 0.0:
            return Const(0.0)
    if op == "*" and len(args) == 2 and isinstance(args[1], Const):
        if args[1].value == 1.0:
            return args[0]
        if args[1].value == 0.0:
            return Const(0.0)
    return Call(op, args)


# ---------------------------------------------------------------------------
# Operator registry
# ---------------------------------------------------------------------------

def _deg(fn):
    return lambda x: fn(x * math.pi / 180.0)


def _cbrt(a):
    """Real cube root.  PyTorch has no ``cbrt``; ``sign(a)*|a|^(1/3)`` has
    the same value and, for a != 0, the same derivative (1/3)|a|^(-2/3)."""
    return torch.sign(a) * torch.abs(a) ** (1.0 / 3.0)


def _build_registries():
    """torch-facing and numpy-facing op tables.  Parity with the 43-operator
    registry of the reference (InfiniteExaModels.jl/src/operators.jl:2-55)."""
    import numpy as np

    d2r = math.pi / 180.0
    torch_ops = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "*": lambda a, b: a * b,
        "/": lambda a, b: a / b,
        "^": lambda a, b: a ** b,
        "neg": lambda a: -a,
        "inv": lambda a: 1.0 / a,
        "sqrt": torch.sqrt,
        "cbrt": _cbrt,
        "abs": torch.abs,
        "abs2": lambda a: a * a,
        "exp": torch.exp,
        "exp2": torch.exp2,
        "log": torch.log,
        "log2": torch.log2,
        "log10": torch.log10,
        "log1p": torch.log1p,
        "sin": torch.sin,
        "cos": torch.cos,
        "tan": torch.tan,
        "asin": torch.asin,
        "acos": torch.acos,
        "atan": torch.atan,
        "csc": lambda a: 1.0 / torch.sin(a),
        "sec": lambda a: 1.0 / torch.cos(a),
        "cot": lambda a: 1.0 / torch.tan(a),
        "acot": lambda a: torch.atan(1.0 / a),
        "sind": lambda a: torch.sin(a * d2r),
        "cosd": lambda a: torch.cos(a * d2r),
        "tand": lambda a: torch.tan(a * d2r),
        "cscd": lambda a: 1.0 / torch.sin(a * d2r),
        "secd": lambda a: 1.0 / torch.cos(a * d2r),
        "cotd": lambda a: 1.0 / torch.tan(a * d2r),
        "atand": lambda a: torch.atan(a) / d2r,
        "acotd": lambda a: torch.atan(1.0 / a) / d2r,
        "sinh": torch.sinh,
        "cosh": torch.cosh,
        "tanh": torch.tanh,
        "csch": lambda a: 1.0 / torch.sinh(a),
        "sech": lambda a: 1.0 / torch.cosh(a),
        "coth": lambda a: 1.0 / torch.tanh(a),
        "asinh": torch.asinh,
        "acosh": torch.acosh,
        "atanh": torch.atanh,
        "acoth": lambda a: torch.atanh(1.0 / a),
    }
    np_ops = {
        "+": lambda a, b: a + b,
        "-": lambda a, b: a - b,
        "*": lambda a, b: a * b,
        "/": lambda a, b: a / b,
        "^": lambda a, b: a ** b,
        "neg": lambda a: -a,
        "inv": lambda a: 1.0 / a,
        "sqrt": np.sqrt,
        "cbrt": np.cbrt,
        "abs": np.abs,
        "abs2": lambda a: a * a,
        "exp": np.exp,
        "exp2": np.exp2,
        "log": np.log,
        "log2": np.log2,
        "log10": np.log10,
        "log1p": np.log1p,
        "sin": np.sin,
        "cos": np.cos,
        "tan": np.tan,
        "asin": np.arcsin,
        "acos": np.arccos,
        "atan": np.arctan,
        "csc": lambda a: 1.0 / np.sin(a),
        "sec": lambda a: 1.0 / np.cos(a),
        "cot": lambda a: 1.0 / np.tan(a),
        "acot": lambda a: np.arctan(1.0 / a),
        "sind": lambda a: np.sin(a * d2r),
        "cosd": lambda a: np.cos(a * d2r),
        "tand": lambda a: np.tan(a * d2r),
        "cscd": lambda a: 1.0 / np.sin(a * d2r),
        "secd": lambda a: 1.0 / np.cos(a * d2r),
        "cotd": lambda a: 1.0 / np.tan(a * d2r),
        "atand": lambda a: np.arctan(a) / d2r,
        "acotd": lambda a: np.arctan(1.0 / a) / d2r,
        "sinh": np.sinh,
        "cosh": np.cosh,
        "tanh": np.tanh,
        "csch": lambda a: 1.0 / np.sinh(a),
        "sech": lambda a: 1.0 / np.cosh(a),
        "coth": lambda a: 1.0 / np.tanh(a),
        "asinh": np.arcsinh,
        "acosh": np.arccosh,
        "atanh": np.arctanh,
        "acoth": lambda a: np.arctanh(1.0 / a),
    }
    return torch_ops, np_ops


TORCH_OPS, NUMPY_OPS = _build_registries()


def apply_op(name, *args):
    """Build a Call node for a registered nonlinear operator; errors with an
    actionable message on unsupported ops (parity with reference
    InfiniteExaModels.jl/src/operators.jl:49-55)."""
    if name not in TORCH_OPS:
        raise ValueError(
            f"nonlinear operator `{name}` is not supported by the SIMD core; "
            "if you need it, add it to ops/expr.py:TORCH_OPS")
    return _call(name, *args)


# convenience math functions usable on template expressions ------------------

def _unary(name):
    def fn(x):
        return apply_op(name, x)

    fn.__name__ = name
    return fn


sin = _unary("sin")
cos = _unary("cos")
tan = _unary("tan")
exp = _unary("exp")
log = _unary("log")
sqrt = _unary("sqrt")
tanh = _unary("tanh")
abs2 = _unary("abs2")


# ---------------------------------------------------------------------------
# Template analysis & code emission
# ---------------------------------------------------------------------------


def collect_entries(expr):
    """Walk a template, deduplicating leaves by structural key.

    Returns (var_entries, par_entries, field_names): ordered unique lists.
    """
    var_entries, par_entries, fields = {}, {}, {}

    def walk(node):
        if isinstance(node, VarEntry):
            var_entries.setdefault(node.key(), node)
        elif isinstance(node, ParamEntry):
            par_entries.setdefault(node.key(), node)
        elif isinstance(node, FieldRef):
            fields.setdefault(node.name, node)
        elif isinstance(node, Call):
            for a in node.args:
                walk(a)

    walk(expr)
    return (list(var_entries.values()), list(par_entries.values()),
            list(fields.keys()))


def emit(expr, var_slots, par_slots, field_slots):
    """Compile a template to ``fn(xv, pv, fv) -> scalar`` over gathered
    values.  ``var_slots``/``par_slots`` map entry keys to positions in the
    gathered arrays; ``field_slots`` maps field names likewise.  The emitted
    closure runs under ``torch.func`` transforms (vmap over rows, grad,
    hessian, jvp).  A template that is a bare constant still returns a
    tensor, since ``torch.func`` transforms need tensor outputs."""

    def build(node):
        if isinstance(node, Const):
            v = node.value
            return lambda xv, pv, fv: v
        if isinstance(node, FieldRef):
            j = field_slots[node.name]
            return lambda xv, pv, fv: fv[j]
        if isinstance(node, VarEntry):
            j = var_slots[node.key()]
            return lambda xv, pv, fv: xv[j]
        if isinstance(node, ParamEntry):
            j = par_slots[node.key()]
            return lambda xv, pv, fv: pv[j]
        if isinstance(node, Call):
            fn = TORCH_OPS[node.op]
            args = [build(a) for a in node.args]
            if len(args) == 1:
                a0 = args[0]
                return lambda xv, pv, fv: fn(a0(xv, pv, fv))
            if len(args) == 2:
                a0, a1 = args
                return lambda xv, pv, fv: fn(a0(xv, pv, fv), a1(xv, pv, fv))
            return lambda xv, pv, fv: fn(*[a(xv, pv, fv) for a in args])
        raise TypeError(f"unknown template node {node!r}")

    if isinstance(expr, Const):
        v = expr.value
        return lambda xv, pv, fv: xv.new_full((), v)
    return build(expr)
