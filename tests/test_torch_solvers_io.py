"""The port's solvers, I/O, describe and profiling against the JAX
package (CPU).

* ``richardson_solve``'s iterate and residual trajectory (stencil 2D and
  3D, forward and symmetric sweeps, an LRC operator, a graph operator),
  ``cg_solve`` stopped early (``maxiter=7``) and run to its tolerance,
  and ``gmres_solve`` stopped after one restart of 5 (forward and
  symmetric preconditioners) and run to its tolerance, against JAX in
  float64 to 1e-10: an early stop tests the iteration, not only its
  limit;
* ``save_chain_state`` / ``load_chain_state`` round trip, and reading a
  JAX-written file (x carried over, the key given, refused without it);
* the two VTK writers byte for byte against JAX's on the same fields;
* ``describe`` against JAX's text line for line on three
  configurations, the ``impl=`` token aside (it names the port's route);
* ``profiling.trace`` writes a Chrome trace with a span in it.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu import io as jio
from parmgmc_tpu import solvers as jsolvers
from parmgmc_tpu.chain import ChainState as JaxChainState
from parmgmc_tpu.describe import describe as jax_describe
from parmgmc_tpu.models.obs import make_posterior_operator as jax_make_posterior_operator
from parmgmc_tpu.operators import stencil as jst
from parmgmc_tpu.operators.graph import from_csr as jax_from_csr
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch import io, profiling, solvers
from parmgmc_tpu_torch.chain import ChainState
from parmgmc_tpu_torch.describe import describe
from parmgmc_tpu_torch.models import mesh
from parmgmc_tpu_torch.models.obs import make_posterior_operator
from parmgmc_tpu_torch.operators.graph import from_csr
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

# the entry points default to the card; these tests run on the host
DEV = "cpu"
F32, F64 = torch.float32, torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, want, tol=1e-10):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max()), np.abs(got - want).max()


def _pair(shape, kappa):
    return (shifted_laplace_fd(shape, kappa, dtype=F64, device=DEV),
            jst.shifted_laplace_fd(shape, kappa, dtype=jnp.float64))


def _rhs(shape, seed=0):
    b = np.random.default_rng(seed).standard_normal(shape) + 1.0
    return torch.from_numpy(b), jnp.asarray(b)


def _lrc_pair():
    op, jop = _pair((9, 9), 3.0)
    coords, radii, obs = np.array([[0.3, 0.4], [0.7, 0.6]]), np.array([0.2, 0.25]), np.array([0.5, -1.0])
    return (make_posterior_operator(op, 0.05, coords, radii, obs)[0],
            jax_make_posterior_operator(jop, 0.05, coords, radii, obs)[0])


def _graph_pair():
    pts, cells = mesh.unit_square_mesh(5)
    A = mesh.matern_precision_mesh(pts, cells, 8.0)
    return from_csr(A, device=DEV), jax_from_csr(A, dtype=jnp.float64)


@pytest.mark.parametrize("case,sweep", [("2d", "forward"), ("3d", "symmetric"), ("lrc", "forward"),
                                        ("graph", "symmetric")])
def test_richardson_matches_jax(case, sweep):
    if case == "lrc":
        op, jop = _lrc_pair()
    elif case == "graph":
        op, jop = _graph_pair()
    else:
        op, jop = _pair((9, 9) if case == "2d" else (5, 6, 7), 2.0)
    shape = (op.base if case == "lrc" else op).grid_shape if case != "graph" else (op.n,)
    b, jb = _rhs(shape)
    x, res = solvers.richardson_solve(op, b, maxiter=12, omega=1.1, sweep=sweep)
    jx, jres = jsolvers.richardson_solve(jop, jb, maxiter=12, omega=1.1, sweep=sweep)
    _close(x, jx)
    _close(res, jres)
    assert res.shape == (12,) and float(res[-1]) < float(res[0])


@pytest.mark.parametrize("shape", [(9, 9), (5, 6, 7)])
def test_cg_matches_jax(shape):
    op, jop = _pair(shape, 1.0)
    b, jb = _rhs(shape, 1)
    # stopped early: 7 iterations of the recurrence, far from converged
    x = solvers.cg_solve(op, b, tol=1e-14, maxiter=7)
    _close(x, jsolvers.cg_solve(jop, jb, tol=1e-14, maxiter=7))
    x7, k = solvers.cg(op.apply, b, tol=1e-14, maxiter=7, M=solvers.sor_preconditioner(op))
    assert k == 7 and torch.equal(x7, x)
    # to its tolerance: the same iterate where both stop
    x = solvers.cg_solve(op, b, tol=1e-8)
    _close(x, jsolvers.cg_solve(jop, jb, tol=1e-8))
    assert float(torch.linalg.vector_norm(b - op.apply(x)) / torch.linalg.vector_norm(b)) < 1e-7


@pytest.mark.parametrize("sweep", ["forward", "symmetric"])
def test_gmres_matches_jax(sweep):
    op, jop = _pair((9, 9), 1.5)
    b, jb = _rhs((9, 9), 2)
    # one restart of 5 Arnoldi steps
    x = solvers.gmres_solve(op, b, restart=5, maxiter=1, sweep=sweep)
    _close(x, jsolvers.gmres_solve(jop, jb, restart=5, maxiter=1, sweep=sweep))
    # restarted to the (preconditioned) tolerance
    x = solvers.gmres_solve(op, b, tol=1e-9, restart=6, maxiter=50, sweep=sweep)
    _close(x, jsolvers.gmres_solve(jop, jb, tol=1e-9, restart=6, maxiter=50, sweep=sweep))


def test_chain_state_round_trip(tmp_path):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 5, 6)).astype(np.float32))
    key = (1 << 64) - 12345  # a key past 2^63 survives as uint64
    io.save_chain_state(str(tmp_path / "st"), ChainState(x=x, key=key))
    st = io.load_chain_state(str(tmp_path / "st"), device=DEV)
    assert torch.equal(st.x, x) and st.key == key and isinstance(st.key, int)
    assert io.load_chain_state(str(tmp_path / "st.npz"), key=7, device=DEV).key == 7


def test_load_a_jax_chain_state(tmp_path):
    import jax

    xj = np.random.default_rng(4).standard_normal((6, 7))
    path = str(tmp_path / "jax_state.npz")
    jio.save_chain_state(path, JaxChainState(x=jnp.asarray(xj), key=jax.random.PRNGKey(3)))
    with pytest.raises(ValueError, match="key="):
        io.load_chain_state(path, device=DEV)
    st = io.load_chain_state(path, key=42, device=DEV)
    assert st.key == 42 and np.array_equal(st.x.numpy(), xj)


def test_vtk_writers_match_jax_bytes(tmp_path):
    rng = np.random.default_rng(5)
    cases = [
        {"mean": rng.standard_normal((5, 7)), "var": rng.random((5, 7))},
        {"mean": rng.standard_normal((3, 4, 5)).astype(np.float32)},
    ]
    for i, fields in enumerate(cases):
        mine, theirs = tmp_path / f"p{i}.vtk", tmp_path / f"j{i}.vtk"
        io.write_vtk_structured(str(mine), {k: torch.from_numpy(v) for k, v in fields.items()})
        jio.write_vtk_structured(str(theirs), {k: jnp.asarray(v) for k, v in fields.items()})
        assert mine.read_bytes() == theirs.read_bytes()
    for d in (2, 3):
        pts = rng.random((7, d))
        cells = rng.integers(0, 7, size=(4, d + 1))
        f = rng.standard_normal(7)
        mine, theirs = tmp_path / f"pu{d}.vtk", tmp_path / f"ju{d}.vtk"
        io.write_vtk_unstructured(str(mine), torch.from_numpy(pts), cells, {"f": torch.from_numpy(f)})
        jio.write_vtk_unstructured(str(theirs), pts, cells, {"f": jnp.asarray(f)})
        assert mine.read_bytes() == theirs.read_bytes()


def _strip_impl(text):
    return re.sub(r"impl=[A-Za-z_]+", "impl=*", text).splitlines()


def test_describe_matches_jax():
    """Three configurations: the aggregate 2D MGMC of JAX's own describe
    test (float64: impl=torch), a float32 3D V(1,0) (the sweep kernel's
    route; JAX on the CPU says lax), and a 2D posterior MGMC (LRC levels,
    low-rank corrected smoothers)."""
    op, jop = _pair((16, 16), 2.0)
    smp = MGMCSampler.create(op, n_levels=2, omega=1.4, coarsening="aggregate")
    jsmp = JaxMGMCSampler.create(jop, n_levels=2, omega=1.4, coarsening="aggregate")
    txt = describe(smp)
    assert _strip_impl(txt) == _strip_impl(jax_describe(jsmp)) and "impl=torch" in txt

    op3 = shifted_laplace_fd((8, 8, 16), 1.0, device=DEV)
    kw = dict(n_pre=1, n_post=0, coarsest_size=16, coarsening="aggregate")
    txt = describe(MGMCSampler.create(op3, **kw))
    want = jax_describe(JaxMGMCSampler.create(jst.shifted_laplace_fd((8, 8, 16), 1.0), **kw))
    assert _strip_impl(txt) == _strip_impl(want) and "impl=fused_rb_gibbs_sweep_fd" in txt

    post, jpost = _lrc_pair()
    txt = describe(MGMCSampler.create(post, n_levels=2))
    want = jax_describe(JaxMGMCSampler.create(jpost, n_levels=2))
    assert _strip_impl(txt) == _strip_impl(want) and "impl=torch, low-rank corrected" in txt


def test_profiling_trace_writes_a_file(tmp_path):
    """``trace`` turns spans on for its block only, and its Chrome file
    names the span."""
    prev = profiling.enable(False)
    try:
        with profiling.trace(str(tmp_path / "prof")):
            assert profiling.enabled()
            with profiling.span("pmg.test.scope"):
                torch.ones(64).cumsum(0)
        assert not profiling.enabled()
    finally:
        profiling.enable(prev)
    path = tmp_path / "prof" / "trace.json"
    assert path.exists()
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "pmg.test.scope" in names
    assert os.path.getsize(path) > 0
