from .expr import (  # noqa: F401
    Expr, Num, NLExpr, Comparison, QuadForm, as_expr, all_refs, map_refs,
    sin, cos, tan, asin, acos, atan, sinh, cosh, tanh, exp, log, log2,
    log10, log1p, sqrt, cbrt, abs2, absval,
)
from .sets import (  # noqa: F401
    IntervalDomain, UniformDist, NormalDist, MvNormalDist, ProductDist,
    uniform, normal, mvnormal,
)
from .derivatives import (  # noqa: F401
    FiniteDifference, OrthogonalCollocation, Forward, Central, Backward,
)
from .refs import (  # noqa: F401
    ParameterGroup, InfiniteParameter, FiniteParameter, FiniteVar,
    InfiniteVar, DerivativeRef, SemiInfiniteVar, PointVar,
    ParameterFunctionRef, MeasureRef, DomainRestriction, VarInfo,
    All, PublicLabel, InternalLabel,
)
from .measures import (  # noqa: F401
    integral, expect, support_sum, deriv, constant_over_collocation,
)
from .model import InfiniteModel, Infinite, ConstraintRef, MIN, MAX  # noqa: F401
