from .expr import (  # noqa: F401
    Expr, Const, FieldRef, VarEntry, ParamEntry, IdxAff, apply_op,
    sin, cos, tan, exp, log, sqrt, tanh, abs2, lift,
)
from .iterators import Iterator, DataSource, SRC  # noqa: F401
from .core import Core, Variable, Parameter  # noqa: F401
from .model import SimdModel  # noqa: F401
