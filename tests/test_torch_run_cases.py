"""The port's ESCAPE34 sweep harness (``infiniteexamodels_jl_torch.tools.
run_cases``) against the JAX package's (``benchmarks/run_cases.py``) on the
CPU: the same rows (nvar, ncon, status and the objective within 1e-6
relative; the iterations equal at quad-12 and, at opf-64, within the
spread of f64 round-off that ROADMAP Queue 3.4 records), the JAX harness's
CSV columns in its order, and no run without CUDA unless ``--device cpu``
is given."""
import csv
import importlib.util
import pathlib

import pytest

from infiniteexamodels_jl_tpu import models as jmodels
from infiniteexamodels_jl_torch import models as tmodels
from infiniteexamodels_jl_torch.tools import run_cases as trc

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_harness():
    spec = importlib.util.spec_from_file_location(
        "jax_run_cases", ROOT / "benchmarks" / "run_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jrc():
    return _jax_harness()


def _rows(path):
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh)
        return reader.fieldnames, list(reader)


def _same_row(port, jax, iter_spread=0):
    assert (int(port["nvar"]), int(port["ncon"]), port["status"]) == \
        (jax["nvar"], jax["ncon"], jax["status"])
    assert abs(int(port["iters"]) - jax["iters"]) <= iter_spread, (
        port["iters"], jax["iters"])
    obj = float(port["objective"])
    assert abs(obj - jax["objective"]) <= 1e-6 * abs(jax["objective"])


def test_quad12_cli_matches_the_jax_harness(jrc, tmp_path, monkeypatch):
    """The port's command line at quad-12 (its prerun included) writes the
    row the JAX harness's ``solve_one`` gives, under the JAX harness's
    columns (read from the CSV it writes for that row)."""
    jax = jrc.solve_one(jmodels.quad, dict(num_supports=12))
    assert trc.main(["quad", "--sizes", "12", "--device", "cpu",
                     "--outdir", str(tmp_path / "port")]) == 0
    cols, rows = _rows(tmp_path / "port" / "quadrotor_ipm_results.csv")
    assert len(rows) == 1 and rows[0]["framework"] == trc.FRAMEWORK
    assert rows[0]["num_supports"] == "12"
    _same_row(rows[0], jax)
    monkeypatch.setattr(jrc, "solve_one", lambda fn, kw: dict(jax))
    jrc.run_cases("quadrotor", jmodels.quad, [dict(num_supports=12)],
                  str(tmp_path / "jax"), prerun=False)
    jcols, _ = _rows(tmp_path / "jax" / "quadrotor_ipm_results.csv")
    assert cols == jcols
    tex = (tmp_path / "port" / "quadrotor_ipm_results.tex").read_text()
    assert tex.startswith("\\begin{tabular}") and "InfiniteExaModelsTorch" \
        in tex


def test_opf64_solve_one_matches_the_jax_harness(jrc):
    """opf-64 (scenario KKT, 65 blocks of 24, border 6): the cold and warm
    solves of both harnesses.  The iterations are held within 2: on one CPU
    the JAX package takes 20 and the port 22 to the same objective, f64
    round-off steering the IPM (ROADMAP Queue 3.4)."""
    jax = jrc.solve_one(jmodels.opf, dict(num_supports=64))
    out, info = trc.solve_one(tmodels.opf, dict(num_supports=64), "cpu")
    _same_row(out, jax, iter_spread=2)
    assert info == {"kkt": "BlockTridiagKKT", "mode": "block_diag",
                    "nb": 65, "bs": 24, "mB": 6,
                    "k1_launches_per_factorization": None,
                    "k1_launches_per_factorization_structure": 1,
                    "peak_memory_above_baseline_bytes": None}
    assert out["total_time"] > 0 and out["solve_time"] > 0
    assert 0 < out["ad_time"] <= out["solve_time"]


def test_without_cuda_it_raises(monkeypatch, tmp_path):
    """No ``--device`` means the card; without CUDA that raises before
    anything is built (no CPU fallback)."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trc.main(["quad", "--sizes", "12", "--outdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_default_outdir_is_git_ignored():
    rel = pathlib.Path(trc.RESULTS).resolve().relative_to(ROOT)
    assert f"{rel.as_posix()}/" in (ROOT / ".gitignore").read_text().split()
