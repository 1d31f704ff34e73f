"""The band/scenario KKT's structure analysis on the card
(``solvers/block_tridiag.py``): at quad-1000 (band) and opf-1000 (scenario
blocks with a border of 6) the analysis computed by torch on the card
gives the tables it gives on the CPU, and the numpy path's, element by
element.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -o addopts="" -m cuda \\
        tests/test_torch_kkt_analysis_cuda.py
"""
import numpy as np
import pytest
import torch

from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.solvers.block_tridiag import BlockTridiagKKT
from infiniteexamodels_jl_torch.transcribe import transcribe
from test_torch_kkt_analysis import (assert_structure_equal,
                                     assert_tables_equal, numpy_analysis)

MODELS = {"quad-1000": lambda: tmodels.quad(num_supports=1000),
          "opf-1000": lambda: tmodels.opf(num_supports=1000)}
MODES = {"quad-1000": ("band", 0), "opf-1000": ("block_diag", 6)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the analysis under test runs there")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request, card):
    cpu = transcribe(MODELS[request.param](), device="cpu")[0]
    dev = transcribe(MODELS[request.param](), device=card)[0]
    assert np.array_equal(cpu.hess_rows_np, dev.hess_rows_np)
    assert np.array_equal(cpu.hess_cols_np, dev.hess_cols_np)
    return (request.param, BlockTridiagKKT(cpu), BlockTridiagKKT(dev),
            numpy_analysis(cpu))


@pytest.mark.cuda
def test_the_card_analysis_equals_the_cpu_one(case):
    name, on_cpu, on_card, _ = case
    assert (on_card.mode, on_card.mB) == MODES[name] and on_card.usable
    for attr in ("n", "nT", "mB", "usable", "mode", "bs", "nb", "nTpad",
                 "block_diag"):
        assert getattr(on_card, attr) == getattr(on_cpu, attr), attr
    for attr in ("_slot_np", "t_ids_np", "b_ids_np"):
        assert np.array_equal(getattr(on_card, attr), getattr(on_cpu, attr))
    for attr in "DLBC":
        a, b = getattr(on_cpu, attr + "_plan"), getattr(on_card, attr + "_plan")
        assert len(a.tabs) == len(b.tabs), attr
        for ta, tb in zip(a.tabs, b.tabs):
            assert tb.is_cuda and torch.equal(ta, tb.cpu()), attr
        assert b.u.is_cuda and torch.equal(a.u, b.u.cpu()), attr
    for attr in ("b_ids", "diag_take", "diag_dest", "slot_src", "slot_mask",
                 "out_perm", "pad_eye"):
        a, b = getattr(on_cpu, attr), getattr(on_card, attr)
        assert b.is_cuda and b.dtype == a.dtype, attr
        assert torch.equal(a, b.cpu()), attr


@pytest.mark.cuda
def test_the_card_analysis_equals_the_numpy_one(case):
    _, _, on_card, want = case
    assert_structure_equal(on_card, want)
    assert_tables_equal(on_card, want)
