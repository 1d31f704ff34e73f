"""Benchmark/example model families (pure DSL): the seven families of the
reference package, under the same names."""
from .hovercraft import hovercraft  # noqa: F401
from .quadrotor import quad  # noqa: F401
from .pandemic import pandemic  # noqa: F401
from .kinetics import kinetic_control  # noqa: F401
from .farmer import farmer  # noqa: F401
from .design_3node import design_3node  # noqa: F401
from .opf import opf, opf_static  # noqa: F401
from .matpower import parse_matpower, build_ref, CASE3, CASE3_LMBD  # noqa: F401
