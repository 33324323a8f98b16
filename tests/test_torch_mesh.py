"""The port's mesh set-up against the JAX package (CPU).

* ``read_gmsh`` of the repo's ``data/wrench.msh`` (no refinement),
  ``write_gmsh`` round trip, ``refine`` with its transfer, P1 and P2 (CG2)
  assembly and the ball-average observation matrices (both orders):
  equal to JAX's to 1e-12;
* the native graph set-up (``parmgmc_tpu_torch/native``) against its
  Python twins, bit for bit: the greedy colouring, the aggregation of a
  strength graph and the ELL pack;
* ``from_csr`` equal to JAX's in every field (permutation, colour blocks,
  prefix counts, ELL values and columns, diagonal), on the unit square
  and the wrench.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models import mesh as jmesh
from parmgmc_tpu.operators.aggregation import _strength_graph as jax_strength_graph
from parmgmc_tpu.operators.graph import from_csr as jax_from_csr
from parmgmc_tpu_torch import native
from parmgmc_tpu_torch.models import mesh
from parmgmc_tpu_torch.operators.aggregation import _strength_graph, aggregate_py
from parmgmc_tpu_torch.operators.graph import ell_pack_py, from_csr, greedy_coloring_py

# the entry points default to the card; these tests run on the host
DEV = "cpu"
TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(a, b, tol=TOL):
    a = a.toarray() if hasattr(a, "toarray") else np.asarray(a, np.float64)
    b = b.toarray() if hasattr(b, "toarray") else np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def wrench():
    return mesh.read_gmsh(mesh.mesh_path("wrench"))


def test_read_gmsh_and_round_trip(wrench, tmp_path):
    pts, cells = wrench
    jpts, jcells = jmesh.read_gmsh(jmesh.mesh_path("wrench"))
    assert pts.shape == (199, 3) and cells.shape == (368, 4)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(cells, jcells)
    path = str(tmp_path / "w.msh")
    mesh.write_gmsh(path, pts, cells)
    p2, c2 = mesh.read_gmsh(path)
    np.testing.assert_array_equal(p2, pts)
    np.testing.assert_array_equal(c2, cells)


@pytest.mark.parametrize("which", ["square", "wrench"])
def test_refine_with_transfer_matches_jax(which, wrench):
    pts, cells = mesh.unit_square_mesh(3) if which == "square" else wrench
    p, c, P = mesh.refine(pts, cells, return_transfer=True)
    jp, jc, jP = jmesh.refine(pts, cells, return_transfer=True)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(c, jc)
    _close(P, jP)
    # P interpolates the coarse coordinates (P1 reproduces linears)
    _close(P @ pts, p)


@pytest.mark.parametrize("which", ["square", "wrench"])
def test_p1_assembly_matches_jax(which, wrench):
    pts, cells = mesh.unit_square_mesh(5) if which == "square" else wrench
    K, M = mesh.assemble_p1(pts, cells)
    jK, jM = jmesh.assemble_p1(pts, cells)
    _close(K, jK)
    _close(M, jM)
    _close(mesh.matern_precision_mesh(pts, cells, 5.0), jmesh.matern_precision_mesh(pts, cells, 5.0))
    assert abs(K @ np.ones(K.shape[0])).max() < 1e-12 * abs(K).max()


def test_p2_assembly_matches_jax():
    pts, cells = mesh.unit_square_mesh(4)
    K, M, dp = mesh.assemble_p2(pts, cells)
    jK, jM, jdp = jmesh.assemble_p2(pts, cells)
    _close(K, jK)
    _close(M, jM)
    np.testing.assert_array_equal(dp, jdp)
    A, dp2 = mesh.matern_precision_mesh_p2(pts, cells, 2.0)
    jA, _ = jmesh.matern_precision_mesh_p2(pts, cells, 2.0)
    _close(A, jA)
    assert abs(M.sum() - 1.0) < 1e-12


@pytest.mark.parametrize("order", [1, 2])
def test_observation_matrices_match_jax(order):
    pts, cells = mesh.unit_square_mesh(6)
    args = (pts, cells, 0.01, [[0.3, 0.3], [0.7, 0.6]], [0.25, 0.2], [1.0, -0.5])
    B, si, f = mesh.mesh_observation_mats(*args, order=order)
    jB, jsi, jf = jmesh.mesh_observation_mats(*args, order=order)
    for a, b in ((B, jB), (si, jsi), (f, jf)):
        _close(a, b)


def test_masked_grid_mesh_matches_jax():
    def inside(x):
        return np.linalg.norm(x - 0.5, axis=-1) < 0.45

    p, c = mesh.masked_grid_mesh([[0, 1], [0, 1]], 0.1, inside)
    jp, jc = jmesh.masked_grid_mesh([[0, 1], [0, 1]], 0.1, inside)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(c, jc)


def _offdiag(A):
    import scipy.sparse as sp

    Ao = (A - sp.diags(A.diagonal())).tocsr()
    Ao.eliminate_zeros()
    return Ao


@pytest.mark.parametrize("which", ["square", "wrench"])
def test_native_graph_setup_is_its_python_twin(which, wrench):
    pts, cells = mesh.unit_square_mesh(8) if which == "square" else mesh.refine(*wrench)
    A = mesh.matern_precision_mesh(pts, cells, 2.0)
    Ao = _offdiag(A)
    n = A.shape[0]
    np.testing.assert_array_equal(native.greedy_coloring(Ao.indptr, Ao.indices, n),
                                  greedy_coloring_py(Ao.indptr, Ao.indices, n))
    w = int(np.diff(Ao.indptr).max())
    for a, b in zip(native.ell_pack(Ao.indptr, Ao.indices, Ao.data, n, w),
                    ell_pack_py(Ao.indptr, Ao.indices, Ao.data, n, w)):
        np.testing.assert_array_equal(a, b)
    S = _strength_graph(A, 0.02)
    assert (S != jax_strength_graph(A, 0.02)).nnz == 0
    agg, n_agg = native.aggregate(S.indptr, S.indices, n)
    agg_py, n_agg_py = aggregate_py(S)
    np.testing.assert_array_equal(agg, agg_py)
    assert n_agg == n_agg_py and 1 < n_agg < n


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises with the compiler's output (no silent fall
    back to the Python loops)."""
    bad = tmp_path / "graph_setup.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="failed"):
        native.build()


@pytest.mark.parametrize("which", ["square", "wrench"])
def test_from_csr_matches_jax(which, wrench):
    pts, cells = mesh.unit_square_mesh(6) if which == "square" else wrench
    A = mesh.matern_precision_mesh(pts, cells, 5.0)
    op = from_csr(A, device=DEV)
    jop = jax_from_csr(A, dtype=jnp.float64)
    assert op.device.type == "cpu" and op.dtype == torch.float64
    assert op.color_starts == jop.color_starts
    assert op.color_counts == jop.color_counts
    for name in ("perm", "iperm", "cols", "vals", "diag"):
        np.testing.assert_array_equal(getattr(op, name).numpy(), np.asarray(getattr(jop, name)))
    # the port's flat per-colour gather reads each block's own widest row
    assert [b[2].shape[1] for b in op.blocks] == [len(cc) for cc in op.color_counts]
    perm = op.perm.numpy()
    _close(op.to_dense().numpy(), A.toarray()[perm][:, perm])
    _close(op.to_csr(), A[perm][:, perm])
