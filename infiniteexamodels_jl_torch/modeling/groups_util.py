"""Parameter-group dependency analysis of DSL expressions (the reference's
parameter_group_int_indices introspection, used throughout transform.jl)."""
from __future__ import annotations

from .expr import all_refs
from .refs import InfiniteParameter, FiniteParameter


def ref_groups(ref):
    if isinstance(ref, InfiniteParameter):
        return (ref.group,)
    if isinstance(ref, FiniteParameter):
        return ()
    return tuple(ref.groups)


def expr_groups(expr):
    """Unique parameter groups an expression depends on, sorted by gid."""
    seen = {}
    for r in all_refs(expr):
        for g in ref_groups(r):
            seen[g.gid] = g
    return tuple(seen[k] for k in sorted(seen))
