"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points default to the CUDA card instead of falling
back to the CPU."""
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "infiniteexamodels_jl_torch"

_SCRIPT = r"""
import json
import sys
sys.modules["jax"] = None              # any import of jax now fails
sys.modules["jaxlib"] = None
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.models import hovercraft
from infiniteexamodels_jl_torch.solvers import IpmSolver
import infiniteexamodels_jl_torch.interop                  # noqa: F401
import infiniteexamodels_jl_torch.solvers.block_tridiag    # noqa: F401
import infiniteexamodels_jl_torch.solvers.cpp_ldl          # noqa: F401
import infiniteexamodels_jl_torch.parallel                 # noqa: F401
import infiniteexamodels_jl_torch.parallel.distributed     # noqa: F401
import infiniteexamodels_jl_torch.solvers.scenario_shard   # noqa: F401
import infiniteexamodels_jl_torch.solvers.band_shard       # noqa: F401
out = []
for opts in ({}, {"linear_solver": "auto", "factor_dtype": "mixed"},
             {"linear_solver": "ldl_cpp"}):
    m = hovercraft(num_supports=41)
    m.set_transformation_backend(ExaTranscriptionBackend(
        IpmSolver, device="cpu", **opts))
    m.set_silent()
    res = m.optimize()
    out.append(f"{res.status},{m.objective_value()!r}")
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "infiniteexamodels_jl_tpu")
             and sys.modules[k] is not None)
# the shared libraries this process loaded (the host LDL among them)
with open("/proc/self/maps") as f:
    libs = sorted({ln.split()[-1] for ln in f if ".so" in ln})
print(json.dumps({"solves": out, "bad": bad,
                  "native": [p for p in libs if "/native/" in p],
                  "built": [p for p in libs
                            if "/infiniteexamodels_jl_torch/_build/" in p]}))
"""


def test_port_imports_and_solves_without_jax():
    """hovercraft-41 solved three ways without JAX: the dense KKT, the
    "mixed" step set (its band KKT view factored in f32) and the host LDL,
    whose library is the port's own build, never the one in ``native/``;
    the multi-device modules (``parallel``, the sharded KKTs) import
    without JAX as well."""
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(got["solves"]) == 3
    for solve in got["solves"]:
        status, obj = solve.split(",")
        assert status == "first_order"
        assert abs(float(obj) - 0.04245763849025232) <= 1e-6
    assert got["bad"] == [] and got["native"] == []
    assert any("/libldl-" in p for p in got["built"])


def test_no_port_file_names_jax_or_the_jax_package():
    files = [p for p in PORT.rglob("*") if p.is_file()
             and p.suffix in (".py", ".cu", ".cuh", ".h", ".cpp")]
    assert len(files) > 20
    word = re.compile(r"\bjax\b|\bjnp\b|infiniteexamodels_jl_tpu",
                      re.IGNORECASE)
    for p in files:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            assert not word.search(line), f"{p.relative_to(ROOT)}:{i}: {line}"


def test_chip_smoke_imports_neither():
    src = (ROOT / "chip_smoke.py").read_text()
    imports = [ln for ln in src.splitlines()
               if re.match(r"\s*(import|from)\s", ln)]
    assert imports
    for ln in imports:
        assert not re.search(r"\bjax\b|jaxlib|infiniteexamodels_jl_tpu", ln), ln
    assert "importlib" not in src and "__import__" not in src


def test_default_device_is_cuda_and_raises_without_it():
    from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
    from infiniteexamodels_jl_torch.solvers import IpmSolver
    from infiniteexamodels_jl_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        pytest.skip("this host has a CUDA card: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExaTranscriptionBackend(IpmSolver)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


# deliberate differences between the two packages' public names, by
# (sub)package, with the reason
PUBLIC_NAME_DIFFERENCES = {
    # the port's one-process-per-device mesh; the JAX package's mesh is a
    # jax.sharding.Mesh, which it does not export from parallel/
    "parallel": {"Mesh"},
}
# names of the JAX package that the port leaves out, with the reason
PUBLIC_NAMES_LEFT_OUT = {
    # per-phase timers that nothing read: the port's spans and counters
    # (utils/timers.py) took their place
    "utils": {"PhaseTimers"},
}
SUBPACKAGES = ("", "backend", "modeling", "models", "ops", "parallel",
               "solvers", "transcribe", "utils")


def _public_names(pkg):
    """The names a package's ``__init__`` makes public: not private, not
    a module (submodules are attributes once imported, in either
    package)."""
    import types
    return {k for k, v in vars(pkg).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_public_names_match_the_jax_package(sub):
    """Every public name of the JAX package's ``__init__`` (top level and
    each subpackage) is the port's, and the port adds only the listed
    ones; ``from infiniteexamodels_jl_torch import MadIpmSolver`` works as
    the reference's import does."""
    import importlib
    suffix = "." + sub if sub else ""
    ref = importlib.import_module("infiniteexamodels_jl_tpu" + suffix)
    port = importlib.import_module("infiniteexamodels_jl_torch" + suffix)
    extra = PUBLIC_NAME_DIFFERENCES.get(sub, set())
    assert _public_names(ref) - _public_names(port) == \
        PUBLIC_NAMES_LEFT_OUT.get(sub, set())
    assert _public_names(port) - _public_names(ref) <= extra
    from infiniteexamodels_jl_torch import MadIpmSolver  # noqa: F401
