"""Tiny cells on the CPU for the benchmark's own tests."""
import copy

import pytest
import torch

from portbench import registry

SIZES = {"quad-16000": 20, "opf-16000": 10}
# At 10 scenarios the sound answers end with primal_inf up to 2.5e-7 (three
# seeds on the CPU: 9.9e-9, 3.0e-8, 2.5e-7), over the 16,000-scenario
# cell's limit; their float32 controls read 9.5e-8 to 2.8e-7 there, and
# fail on dual_inf (1.4e-4 against at most 7.3e-9) and obj_rel instead.
# At 64 scenarios (the card test's size) a sound answer on the card read
# dual_inf 1.19e-6, at the solver's own stopping tolerance (1e-6 on its
# scaled measure), over the 16,000-scenario cell's limit; the CPU read
# 9.2e-9 there, and the float32 controls at 10 scenarios read 1.4e-4.
TINY_LIMITS = {"opf-16000": {"primal_inf": 1e-6, "dual_inf": 1e-5}}
# The seed the tests draw opf's scenarios from: at 10 scenarios this draw
# solves in 18 iterations on the CPU, where the draw of seed 0 takes 558
# (the JAX package 534), some 450 s; an open question of the solver's, not
# of the harness.
OPF_SEED = 2 ** 31 + 901


def tiny_cell(workload, trace=False, size=None):
    """The cell as ``BENCHMARK.json`` defines it, at a size the CPU solves
    in seconds (quad at 20 supports, opf at 10 scenarios) or at
    ``size``."""
    cell = copy.deepcopy(registry.cell(workload, trace=trace))
    name = cell["config"]["name"]
    n = size or SIZES[name]
    cell["config"]["kwargs"]["num_supports"] = n
    cell["config"]["inputs"]["num_supports"] = n
    cell["config"]["limits"].update(TINY_LIMITS.get(name, {}))
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips a card-only test where there is no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
