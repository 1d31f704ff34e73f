"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points default to the CUDA card instead of falling
back to the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "infiniteexamodels_jl_torch"

_SCRIPT = r"""
import sys
sys.modules["jax"] = None              # any import of jax now fails
sys.modules["jaxlib"] = None
from infiniteexamodels_jl_torch.backend import ExaTranscriptionBackend
from infiniteexamodels_jl_torch.models import hovercraft
from infiniteexamodels_jl_torch.solvers import IpmSolver
import infiniteexamodels_jl_torch.interop                  # noqa: F401
import infiniteexamodels_jl_torch.solvers.block_tridiag    # noqa: F401
m = hovercraft(num_supports=41)
m.set_transformation_backend(ExaTranscriptionBackend(IpmSolver, device="cpu"))
m.set_silent()
res = m.optimize()
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "infiniteexamodels_jl_tpu")
             and sys.modules[k] is not None)
print(res.status, repr(m.objective_value()), bad)
"""


def test_port_imports_and_solves_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    status, obj, bad = out.stdout.strip().splitlines()[-1].split(" ", 2)
    assert status == "first_order"
    assert abs(float(obj) - 0.04245763849025232) <= 1e-6
    assert bad == "[]"


def test_no_port_file_names_jax_or_the_jax_package():
    files = [p for p in PORT.rglob("*") if p.is_file()
             and p.suffix in (".py", ".cu", ".cuh", ".h")]
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
