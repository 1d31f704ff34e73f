"""Transcription mapping store (the reference's ExaMappingData,
InfiniteExaModels.jl/src/infiniteopt_backend.jl:12-83): bidirectional maps between
model references and SIMD-core objects plus the support/alias metadata the
compiler and the result queries share."""
from __future__ import annotations

import numpy as np


class TranscriptionData:
    def __init__(self):
        # ref-id -> ops object
        self.infvar_map = {}     # InfiniteVar/DerivativeRef -> ops.Variable
        self.finvar_map = {}     # FiniteVar/PointVar -> ops.VarEntry
        self.param_map = {}      # FiniteParameter/ParameterFunctionRef -> ops.Parameter
        self.con_map = {}        # ConstraintRef -> ops.ConstraintFamily
        self.deriv_con_map = {}  # DerivativeRef -> ops.ConstraintFamily
        self.semivar_info = {}   # SemiInfiniteVar -> (ops obj, indexing list)
        self._refs = {}          # id -> ref (keeps mapping keys resolvable)

        # per-group metadata
        self.group_alias = []    # ["g0", ...]
        self.param_alias = {}    # id(pref) -> "ip0" / "dp0_1"
        self.base_itrs = []      # [ops.Iterator]
        self.support_labels = []  # [list[set[str]]]
        self.has_internal = []   # [bool]
        self.support_to_index = {}  # (gid, key) -> int

    # -- ref-keyed mapping helpers --------------------------------------
    def _put(self, table, ref, value):
        table[id(ref)] = value
        self._refs[id(ref)] = ref

    def _get(self, table, ref):
        return table.get(id(ref))

    def lookup(self, ref):
        """data[ref] (reference Base.getindex, infiniteopt_backend.jl:60-73)."""
        for table in (self.infvar_map, self.finvar_map, self.param_map):
            v = table.get(id(ref))
            if v is not None:
                return v
        raise KeyError(f"no mapping found for {ref!r}")

    def lookup_constraint(self, cref):
        v = self.con_map.get(id(cref))
        if v is None:
            raise KeyError(f"no mapping found for {cref!r}")
        return v

    # -- support index lookups ------------------------------------------
    @staticmethod
    def _key(value):
        arr = np.atleast_1d(np.asarray(value, dtype=np.float64))
        return tuple(float(v) for v in arr)

    def record_support_index(self, gid, value, idx):
        self.support_to_index[(gid, self._key(value))] = idx

    def support_index(self, gid, value):
        key = (gid, self._key(value))
        idx = self.support_to_index.get(key)
        if idx is not None:
            return idx
        # fallback: nearest within tolerance (float round-trip safety)
        target = np.asarray(key[1])
        best, besterr = None, 1e-9
        for (g, k), i in self.support_to_index.items():
            if g != gid or len(k) != len(target):
                continue
            err = float(np.max(np.abs(np.asarray(k) - target)))
            if err < besterr:
                best, besterr = i, err
        if best is None:
            raise KeyError(
                f"support {value!r} not found in parameter group {gid}")
        return best
