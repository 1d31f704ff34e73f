"""Benchmark model families (pure DSL).  This slice of the port carries the
quadrotor OCP (the benchmark's main path) and the hovercraft OCP (the
dense-against-band parity case)."""
from .hovercraft import hovercraft  # noqa: F401
from .quadrotor import quad  # noqa: F401
