"""The SIMD NLP core: variables, parameters and (template, iterator) families.

Array-native equivalent of ExaModels.jl's ExaCore (observed interface at
InfiniteExaModels.jl/src/transform.jl:113-741 and
InfiniteExaModels.jl/src/infiniteopt_backend.jl:464-527): an NLP is assembled as

- dense variable tensors (``add_var``) with bounds/starts,
- dense parameter tensors (``add_par``) holding mutable data theta,
- constraint families (``add_con``): one template + one iterator,
- objective families (``add_obj``): one template + one iterator, the
  objective being the sum of the template over the iterator rows.

``build()`` freezes the core into a :class:`~.model.SimdModel` whose
function/gradient/Jacobian/Hessian evaluations are batches of identical
PyTorch kernels (one vmapped trace per family).
"""
from __future__ import annotations

import numpy as np

from .expr import Const, Expr, ParamEntry, VarEntry, lift
from .iterators import Iterator


class Variable:
    """A dense decision-variable tensor (ExaModels.Variable analogue).

    ``var[idx...]`` returns a scalar :class:`VarEntry` template leaf; indices
    may be ints or integer-affine expressions of iterator columns.
    """

    __slots__ = ("vid", "name", "offset", "shape", "length")

    def __init__(self, vid, name, offset, shape):
        self.vid = vid
        self.name = name
        self.offset = offset
        self.shape = tuple(shape)
        self.length = int(np.prod(self.shape)) if self.shape else 1

    @property
    def size(self):
        return self.shape

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if len(idx) != len(self.shape):
            raise IndexError(
                f"variable {self.name!r} has {len(self.shape)} axes, "
                f"got {len(idx)} indices")
        return VarEntry(self, idx)

    def entry(self):
        """The scalar entry of a 0-d variable."""
        if self.shape != ():
            raise ValueError("entry() is only for scalar variables")
        return VarEntry(self, ())

    def flat_index(self, idx):
        """Row-major (C-order) flat index of a static entry."""
        if not idx:
            return self.offset
        return self.offset + int(np.ravel_multi_index(idx, self.shape))

    def strides(self):
        """C-order strides in elements."""
        st, acc = [], 1
        for d in reversed(self.shape):
            st.append(acc)
            acc *= d
        return tuple(reversed(st))

    def __repr__(self):
        return f"Variable({self.name!r}, shape={self.shape}, offset={self.offset})"


class Parameter:
    """A dense mutable-data tensor (ExaModels.Parameter analogue); lives in
    the flat theta vector and can be updated without a rebuild
    (reference set_parameter! at InfiniteExaModels.jl/src/infiniteopt_backend.jl:522)."""

    __slots__ = ("pid", "name", "offset", "shape", "length")

    def __init__(self, pid, name, offset, shape):
        self.pid = pid
        self.name = name
        self.offset = offset
        self.shape = tuple(shape)
        self.length = int(np.prod(self.shape)) if self.shape else 1

    @property
    def size(self):
        return self.shape

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if len(idx) != len(self.shape):
            raise IndexError(
                f"parameter {self.name!r} has {len(self.shape)} axes, "
                f"got {len(idx)} indices")
        return ParamEntry(self, idx)

    def entry(self):
        if self.shape != ():
            return ParamEntry(self, (0,) * len(self.shape))
        return ParamEntry(self, ())

    def flat_index(self, idx):
        if not idx:
            return self.offset
        return self.offset + int(np.ravel_multi_index(idx, self.shape))

    def __repr__(self):
        return f"Parameter({self.name!r}, shape={self.shape}, offset={self.offset})"


class ConstraintFamily:
    """One constraint family: ncon_rows = len(itr) identical-template rows."""

    __slots__ = ("cid", "expr", "itr", "offset", "lcon", "ucon", "name")

    def __init__(self, cid, expr, itr, offset, lcon, ucon, name):
        self.cid = cid
        self.expr = expr
        self.itr = itr
        self.offset = offset          # row offset in the flat constraint vector
        self.lcon = lcon              # (n,) arrays
        self.ucon = ucon
        self.name = name

    def __len__(self):
        return len(self.itr)


class ObjectiveFamily:
    __slots__ = ("oid", "expr", "itr", "name")

    def __init__(self, oid, expr, itr, name):
        self.oid = oid
        self.expr = expr
        self.itr = itr
        self.name = name


def _broadcast_bound(value, shape, default):
    if value is None:
        value = default
    if callable(value):
        raise TypeError("bounds must be arrays/scalars at the core level")
    arr = np.asarray(value, dtype=np.float64)
    if arr.shape == ():
        return np.full(shape if shape else (), float(arr))
    if arr.shape != tuple(shape):
        raise ValueError(f"bound shape {arr.shape} != variable shape {shape}")
    return arr.astype(np.float64)


class Core:
    """Mutable NLP under construction.  All data is host numpy until
    ``build()``; bounds/starts/theta stay mutable in-place afterwards through
    the produced model (warm starts, parameter updates)."""

    def __init__(self, minimize=True):
        self.minimize = minimize
        self.variables = []
        self.parameters = []
        self.con_families = []
        self.obj_families = []
        self.nvar = 0
        self.ntheta = 0
        self.ncon = 0
        self._x0_parts = []
        self._lvar_parts = []
        self._uvar_parts = []
        self._theta_parts = []

    # -- variables -------------------------------------------------------
    def add_var(self, shape=(), lvar=None, uvar=None, start=None, name=None):
        if isinstance(shape, int):
            shape = (shape,)
        shape = tuple(int(s) for s in shape)
        name = name or f"v{len(self.variables)}"
        var = Variable(len(self.variables), name, self.nvar, shape)
        self.variables.append(var)
        self.nvar += var.length
        self._lvar_parts.append(_broadcast_bound(lvar, shape, -np.inf).reshape(-1))
        self._uvar_parts.append(_broadcast_bound(uvar, shape, np.inf).reshape(-1))
        self._x0_parts.append(_broadcast_bound(start, shape, 0.0).reshape(-1))
        return var

    def add_par(self, values, name=None):
        arr = np.asarray(values, dtype=np.float64)
        name = name or f"p{len(self.parameters)}"
        par = Parameter(len(self.parameters), name, self.ntheta, arr.shape)
        self.parameters.append(par)
        self.ntheta += par.length
        self._theta_parts.append(arr.reshape(-1).copy())
        return par

    # -- families --------------------------------------------------------
    def add_con(self, expr, itr=None, lcon=0.0, ucon=0.0, name=None):
        if itr is None:
            itr = Iterator.single()
        expr = lift(expr)
        n = len(itr)
        lc = np.broadcast_to(np.asarray(lcon, dtype=np.float64), (n,)).copy()
        uc = np.broadcast_to(np.asarray(ucon, dtype=np.float64), (n,)).copy()
        fam = ConstraintFamily(len(self.con_families), expr, itr, self.ncon,
                               lc, uc, name or f"c{len(self.con_families)}")
        self.con_families.append(fam)
        self.ncon += n
        return fam

    def add_obj(self, expr, itr=None, name=None):
        if itr is None:
            itr = Iterator.single()
        expr = lift(expr)
        fam = ObjectiveFamily(len(self.obj_families), expr, itr,
                              name or f"o{len(self.obj_families)}")
        self.obj_families.append(fam)
        return fam

    # -- flat views ------------------------------------------------------
    @property
    def x0(self):
        return np.concatenate(self._x0_parts) if self._x0_parts else np.zeros(0)

    @property
    def lvar(self):
        return np.concatenate(self._lvar_parts) if self._lvar_parts else np.zeros(0)

    @property
    def uvar(self):
        return np.concatenate(self._uvar_parts) if self._uvar_parts else np.zeros(0)

    @property
    def theta(self):
        return np.concatenate(self._theta_parts) if self._theta_parts else np.zeros(0)

    # in-place mutation helpers (used by the backend for start-value updates,
    # reference InfiniteExaModels.jl/src/infiniteopt_backend.jl:551-592)
    def set_start(self, var, values):
        arr = np.broadcast_to(np.asarray(values, dtype=np.float64),
                              (var.length,))
        self._x0_parts[var.vid][:] = arr

    def set_bounds_entry(self, entry, lvar=None, uvar=None, start=None):
        """Override bounds/start of one static entry in place (point /
        semi-infinite restriction semantics, reference transform.jl:216-231)."""
        var = entry.var
        j = entry.i - var.offset
        if lvar is not None:
            self._lvar_parts[var.vid][j] = lvar
        if uvar is not None:
            self._uvar_parts[var.vid][j] = uvar
        if start is not None:
            self._x0_parts[var.vid][j] = start

    def set_parameter(self, par, values):
        arr = np.broadcast_to(np.asarray(values, dtype=np.float64),
                              (par.length,))
        self._theta_parts[par.pid][:] = arr

    def set_x0_flat(self, values):
        """Overwrite the full flat start vector (warm starts, reference
        NLPModels.get_x0 copyto! at infiniteopt_backend.jl:600)."""
        arr = np.asarray(values, dtype=np.float64)
        if arr.shape != (self.nvar,):
            raise ValueError(f"x0 shape {arr.shape} != ({self.nvar},)")
        pos = 0
        for part in self._x0_parts:
            part[:] = arr[pos:pos + len(part)]
            pos += len(part)

    def build(self, dtype=None, device=None, row_pad=1):
        from .model import SimdModel

        return SimdModel(self, dtype=dtype, device=device, row_pad=row_pad)
