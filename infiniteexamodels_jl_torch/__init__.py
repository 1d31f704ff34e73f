"""PyTorch / CUDA port of the infinite-dimensional optimization framework.

A second package beside the TPU reference package: the same module tree
and class names, written in PyTorch for one NVIDIA H100, with the reference
package's TPU kernel replaced by a hand-written Hopper kernel
(``csrc/chol_linv.cu``).  It imports nothing of the reference package.

- ``modeling``   -- infinite-dimensional modeling DSL (InfiniteOpt role).
- ``transcribe`` -- direct transcription compiler: InfiniteModel -> Core.
- ``ops``        -- SIMD NLP core: per-family expression templates evaluated
  with ``torch.func`` (vmap/grad/hessian/jvp) over iterator rows.
- ``solvers``    -- filter line-search IPM on the condensed KKT; dense and
  band/block-diagonal KKT backends; K1 (batched Cholesky + L^{-1}).
- ``backend``    -- transformation-backend lifecycle and queries.
- ``parallel``   -- meshes and collectives, one process per device (the
  sharded KKTs are in ``solvers``).
- ``models``     -- the seven model families (hovercraft, quadrotor,
  kinetics, pandemic, farmer, design_3node, opf).
- ``tools``      -- command-line tools (``run_examples``, ``profile``).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; nothing here changes global torch state at import.
"""
from .ops import Core, SimdModel  # noqa: F401
from .modeling import (  # noqa: F401
    InfiniteModel,
    Infinite,
    FiniteDifference,
    OrthogonalCollocation,
    Forward,
    Central,
    Backward,
    deriv,
    integral,
    expect,
    support_sum,
    uniform,
    normal,
    mvnormal,
    constant_over_collocation,
    DomainRestriction,
    All,
    PublicLabel,
    InternalLabel,
)
from .backend import ExaTranscriptionBackend, TranscriptionData  # noqa: F401
from .solvers import IpmSolver, MadIpmSolver  # noqa: F401

__version__ = "0.1.0"
