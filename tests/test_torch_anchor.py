"""The CPU anchor: ``parmgmc_tpu_torch.native.ref_sor_bench`` (CPU).

* the library builds at first use, and ``ref_sor_bench(8, nsweeps=2)``
  returns 512 DOFs and positive times;
* ``ref_sor_bench_csr`` on a small port ``GraphOperator.to_csr()`` returns
  its row count, and hands the C loop the diagonal split off as the JAX
  loader does (A - diag(A), explicit zeros eliminated);
* a failed build raises with the compiler's output (the JAX loader
  returns None);
* ``examples.baseline_cpu_reference`` keeps the JAX script's constants
  and its model's arithmetic.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from parmgmc_tpu_torch import native
from parmgmc_tpu_torch.examples import baseline_cpu_reference
from parmgmc_tpu_torch.models.mesh import matern_precision_mesh, unit_square_mesh
from parmgmc_tpu_torch.operators.graph import from_csr

DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ref_sor_bench_builds_and_times():
    ndof, sweep, fill = native.ref_sor_bench(8, nsweeps=2)
    assert ndof == 512 and sweep > 0 and fill > 0
    assert os.path.dirname(native._SOR_SO) == native.BUILD_DIR and os.path.exists(native._SOR_SO)


def test_ref_sor_bench_csr_rows_and_split(monkeypatch):
    pts, cells = unit_square_mesh(6)
    op = from_csr(matern_precision_mesh(pts, cells, 2.0), device=DEV)
    A = op.to_csr()
    n, sweep, fill = native.ref_sor_bench_csr(A, nsweeps=2)
    assert n == op.n == A.shape[0] and sweep > 0 and fill > 0

    # the arrays handed to the C loop: the off-diagonal CSR and the diagonal
    seen = {}

    class Spy:
        def pmg_ref_sor_bench_csr(self, n, rowptr, col, val, diag, nsweeps, omega, *out):
            nnz = rowptr[n]
            seen.update(rowptr=np.ctypeslib.as_array(rowptr, (n + 1,)).copy(),
                        col=np.ctypeslib.as_array(col, (nnz,)).copy(),
                        val=np.ctypeslib.as_array(val, (nnz,)).copy(),
                        diag=np.ctypeslib.as_array(diag, (n,)).copy(), nsweeps=nsweeps, omega=omega)
            return n

    monkeypatch.setattr(native, "sor_lib", lambda: Spy())
    native.ref_sor_bench_csr(A, nsweeps=3, omega=0.9)
    np.testing.assert_array_equal(seen["diag"], A.diagonal())
    off = A.copy()
    off.setdiag(0)
    off.eliminate_zeros()
    np.testing.assert_array_equal(seen["rowptr"], off.indptr)
    np.testing.assert_array_equal(seen["col"], off.indices)
    np.testing.assert_array_equal(seen["val"], off.data)
    assert seen["nsweeps"] == 3 and seen["omega"] == 0.9
    assert (seen["col"] != np.repeat(np.arange(n), np.diff(seen["rowptr"]))).all()


def test_sor_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises with the compiler's output (no None)."""
    bad = tmp_path / "ref_sor_bench.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SOR_SRC", str(bad))
    monkeypatch.setattr(native, "_SOR_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_SOR_LIB", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.ref_sor_bench(4)
    with pytest.raises(RuntimeError, match="failed"):
        native.ref_sor_bench_csr(np.eye(3))


def test_baseline_constants_and_model(capsys):
    jax_base = _jax_script("baseline_cpu_reference")
    for name in ("N_FINE", "CYCLE_SWEEP_EQUIV", "TAU", "RANKS"):
        assert getattr(baseline_cpu_reference, name) == getattr(jax_base, name)
    out = baseline_cpu_reference.main(["8"])
    assert out["edge"] == 8 and out["ndof"] == 512
    rate = out["ndof"] / out["sec_sweep"]
    want = jax_base.RANKS * rate / (jax_base.N_FINE**3 * jax_base.CYCLE_SWEEP_EQUIV)
    assert out["cycles_per_sec"] == pytest.approx(want, rel=1e-12)
    assert out["ess_per_sec"] == pytest.approx(want / jax_base.TAU, rel=1e-12)
    text = capsys.readouterr().out
    assert "grid 8^3 = 512 DOF (f64 CSR, one core)" in text
    assert "64-rank perfect-scaling model on 256^3:" in text

