"""The user-facing examples, ``parmgmc_tpu_torch.examples`` (CPU).

* ``make_meshes``: each geometry's points and cells equal the JAX
  script's exactly, and the files it writes equal ``data/*.msh`` byte for
  byte (written to a temporary directory, never into ``data/``);
* ``benchmark_matern.region_qoi`` equals the JAX script's exactly for
  the three presets on the port's mesh points;
* the exact references the examples hold their samples to (ex1's A^{-1} 1,
  ex4's posterior mean, ex9's (kappa^2 - Lap)^{-2} 1) equal the JAX
  package's to 1e-12 relative;
* each example's ``main`` passes its own acceptance assert at small flags
  (fixed seeds, the JAX bounds unchanged): ex1 with every sampler, ex4
  with every sampler, ex9, ex7, ex2 with a VTK file, ex13_cholsampler at
  refine 0 with an MGMC cross-check, ex13_weak_scaling on 1 and 2 slots in
  each mode, and benchmark_matern's wrench preset with 4 chains and the
  anchor; benchmark_matern's DOFs, levels and level sizes equal the JAX
  ``MaternMeshSampler``'s on the same mesh;
* without ``--device cpu`` every example raises on a host with no card;
* a one-level MGMC sampler steps as JAX's does (its coarse sampler's
  exact draw), and a dense Cholesky sampler starts a chain.
"""

import importlib
import importlib.util
import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parmgmc_tpu.models.matern import MaternMeshSampler as JaxMaternMeshSampler
from parmgmc_tpu.models.obs import make_posterior_operator as jax_make_posterior_operator
from parmgmc_tpu.models.problems import gmrf_2d as jax_gmrf_2d
from parmgmc_tpu.models.problems import squared_shifted_laplace_fd as jax_squared_fd
from parmgmc_tpu.samplers.mgmc import MGMCSampler as JaxMGMCSampler
from parmgmc_tpu_torch import keys
from parmgmc_tpu_torch.chain import init_chain
from parmgmc_tpu_torch.examples import (
    benchmark_matern,
    ex1_samplers,
    ex2_matern_iact,
    ex4_posterior,
    ex7_convergence,
    ex9_squared_prior,
    ex13_cholsampler,
    ex13_weak_scaling,
    make_meshes,
)
from parmgmc_tpu_torch.models.mesh import mesh_path, read_gmsh
from parmgmc_tpu_torch.models.problems import gmrf_2d, squared_shifted_laplace_fd
from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("wrench", "lshape", "piece")
CPU = ["--device", DEV]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_script(name):
    """The JAX package's example script, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _preset(name):
    with open(os.path.join(ROOT, "examples", "benchmark", f"{name}.json")) as f:
        return json.load(f)


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(np.asarray(want)))


# -- make_meshes and region_qoi --------------------------------------------------
@pytest.mark.parametrize("name", sorted(make_meshes.GEOMETRIES))
def test_mesh_geometry_matches_jax(name):
    pts, cells = make_meshes.GEOMETRIES[name]()
    jpts, jcells = _jax_script("make_meshes").GEOMETRIES[name]()
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(cells, jcells)


def test_make_meshes_writes_data_bytes(tmp_path, capsys):
    out = make_meshes.main(["--outdir", str(tmp_path)])
    assert sorted(out) == sorted(make_meshes.GEOMETRIES)
    for name in make_meshes.GEOMETRIES:
        with open(tmp_path / f"{name}.msh", "rb") as a, open(os.path.join(ROOT, "data", f"{name}.msh"), "rb") as b:
            assert a.read() == b.read(), name
    assert "wrench          199 nodes     368 tets" in capsys.readouterr().out


@pytest.mark.parametrize("name", PRESETS)
def test_region_qoi_matches_jax(name):
    preset = _preset(name)
    pts, _ = read_gmsh(mesh_path(preset["mesh"]))
    w = benchmark_matern.region_qoi(pts, preset)
    jw = _jax_script("benchmark_matern").region_qoi(pts, preset)
    assert w is not None and w.sum() == pytest.approx(1.0)
    np.testing.assert_array_equal(w, np.asarray(jw))


# -- exact references ------------------------------------------------------------
def test_ex1_exact_mean_matches_jax():
    got = ex1_samplers.exact_mean(gmrf_2d(9, kappa=10.0, dtype=torch.float64, device=DEV))
    jop = jax_gmrf_2d(9, kappa=10.0, dtype=jnp.float64)
    want = np.linalg.solve(np.asarray(jop.to_dense()), np.ones(jop.n)).reshape(jop.grid_shape)
    assert _rel(got, want) < 1e-12


def test_ex4_posterior_mean_matches_jax():
    op, f = ex4_posterior.posterior_problem(DEV)
    got = ex4_posterior.posterior_mean(op, f)
    jop, jf = jax_make_posterior_operator(
        jax_gmrf_2d(17, kappa=2.0, dtype=jnp.float64), sigma2=1e-2,
        coords=[[0.25, 0.25], [0.75, 0.75], [0.5, 0.3]], radii=[0.12, 0.1, 0.15], obsvals=[0.8, -0.5, 0.3],
    )
    want = np.linalg.solve(np.asarray(jop.to_dense()), np.asarray(jf).ravel()).reshape(jop.grid_shape)
    assert _rel(got, want) < 1e-12


def test_ex9_exact_mean_matches_jax():
    got = ex1_samplers.exact_mean(squared_shifted_laplace_fd((17, 17), 2.0, dtype=torch.float64, device=DEV))
    jop = jax_squared_fd((17, 17), 2.0, dtype=jnp.float64)
    want = np.linalg.solve(np.asarray(jop.to_dense()), np.ones(jop.n)).reshape(jop.grid_shape)
    assert _rel(got, want) < 1e-12


# -- small runs: each example's own assert ---------------------------------------
EX1_FLAGS = {  # kappa 3 (gibbs) or 1 keeps the chains short on one core
    "gibbs": ["--samples", "2000", "--burnin", "100", "--kappa", "3"],
    "gibbs-symmetric": ["--samples", "3000", "--burnin", "100", "--kappa", "3"],
    "cholesky": ["--samples", "500", "--burnin", "100", "--kappa", "1"],
    "mgmc": ["--samples", "500", "--burnin", "100", "--kappa", "1"],
}


@pytest.mark.parametrize("sampler", sorted(ex1_samplers.CONFIGS))
def test_ex1_small_run(sampler, capsys):
    out = ex1_samplers.main(["--sampler", sampler, *EX1_FLAGS[sampler], *CPU])
    assert out["rel"] < 0.05
    assert f"Rel. mean error: {out['rel']:.5f}" in capsys.readouterr().out


EX4_SAMPLES = {"gibbs": 10_000, "mgmc": 1500, "woodbury": 1000}


@pytest.mark.parametrize("sampler", sorted(ex4_posterior.CONFIGS))
def test_ex4_small_run(sampler):
    out = ex4_posterior.main(["--sampler", sampler, "--samples", str(EX4_SAMPLES[sampler]), *CPU])
    assert out["rel"] < 0.05


def test_ex9_small_run():
    out = ex9_squared_prior.main(["--samples", "100", *CPU])
    assert out["rel"] < 0.05


def test_ex7_small_run(capsys):
    out = ex7_convergence.main(["--grid", "9", "--chains", "4", *CPU])
    assert out["rhat"] < 1.05 and out["steps"] % 50 == 0 and out["draws"] == 4 * out["steps"]
    assert "converged after" in capsys.readouterr().out


def test_ex2_small_run_with_vtk(tmp_path, monkeypatch):
    monkeypatch.setattr(ex2_matern_iact, "N_MEAN_VAR", 200)
    path = tmp_path / "ex2.vtk"
    out = ex2_matern_iact.main(["--samples", "400", "--vtk", str(path), *CPU])
    assert abs(out["qoi_mean"]) < 0.05 and out["n"] == 33 * 33
    text = path.read_text()
    assert "DIMENSIONS 33 33 1" in text and "SCALARS mean double 1" in text and "SCALARS var double 1" in text


def test_ex13_cholsampler_small_run(capsys):
    out = ex13_cholsampler.main(["--refine", "0", "--samples", "64", "--mgmc-samples", "200", *CPU])
    assert out["n"] == 199 and len(out["probes"]) == 3 and len(out["cross"]) == 3
    assert out["mgmc_levels"] == 1  # 199 DOFs under coarsest_size=512: the exact coarse draw
    assert "cross-validation OK" in capsys.readouterr().out


@pytest.mark.parametrize("mode", [[], ["--unstructured"], ["--unstructured", "--domain-decompose"],
                                  ["--unstructured", "--domain-decompose", "--posterior"]],
                         ids=["structured", "chains", "dd", "dd-posterior"])
def test_ex13_weak_scaling_small_run(mode, capsys):
    out = ex13_weak_scaling.main(["--devices", "1", "2", "--base", "8", "--samples", "16", "--refine", "0",
                                  *mode, *CPU])
    rows = out["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(math.isfinite(r["ms_per_sample"]) and r["tau"] >= 1.0 for r in rows)
    if not mode:
        assert [r["dofs"] for r in rows] == [8**3, 2 * 8**3]
    if "--domain-decompose" in mode:
        assert rows[0]["ghost_rows"] == 0 and rows[1]["ghost_rows"] > 0
    assert "devices=2: 2 shard slot(s) on 1 cpu device(s)" in capsys.readouterr().out


@pytest.fixture(scope="module")
def wrench_bench():
    torch.set_num_threads(1)
    return benchmark_matern.main(["--preset", os.path.join(ROOT, "examples", "benchmark", "wrench.json"),
                                  "--chains", "4", "--anchor-ranks", "4", "--burnin", "50", "--samples", "200",
                                  *CPU])


def test_benchmark_matern_small_run(wrench_bench):
    out = wrench_bench
    assert out["chains"] == 4 and len(out["tau_sections"]) == 3 and out["tau"] >= 1.0
    assert out["qoi_nodes"] > 0 and out["anchor_n"] == out["dofs"]
    assert out["vs_anchor"] == pytest.approx(out["samples_per_s"] / out["anchor_samples_per_s"])


def test_benchmark_matern_header_matches_jax(wrench_bench):
    preset = _preset("wrench")
    obs = dict(sigma2=preset["sigma2"], coords=preset["obs_coords"], radii=preset["obs_radii"],
               values=preset["obs_values"])
    jms = JaxMaternMeshSampler(mesh_file="wrench", kappa=preset["kappa"], refinements=0, dtype=jnp.float64,
                               observations=obs, coarsest_size=128)
    assert wrench_bench["dofs"] == jms.n and wrench_bench["levels"] == jms.sampler.n_levels
    assert wrench_bench["level_sizes"] == [math.prod(o.grid_shape) for o in jms.sampler.ops]


# -- no silent CPU ---------------------------------------------------------------
@pytest.mark.parametrize("name", ["ex1_samplers", "ex2_matern_iact", "ex4_posterior", "ex7_convergence",
                                  "ex9_squared_prior", "ex13_cholsampler", "ex13_weak_scaling",
                                  "benchmark_matern"])
def test_no_card_raises_without_device_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    mod = importlib.import_module(f"parmgmc_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


# -- the port faults the examples exposed ------------------------------------------
def test_one_level_mgmc_steps_as_jax():
    op = gmrf_2d(5, kappa=1.0, dtype=torch.float64, device=DEV)
    one = MGMCSampler.create(op, n_levels=1)
    jone = JaxMGMCSampler.create(jax_gmrf_2d(5, kappa=1.0, dtype=jnp.float64), n_levels=1)
    assert one.n_levels == jone.n_levels == 1
    rng = np.random.default_rng(0)
    x, b = rng.standard_normal((5, 5)), rng.standard_normal((5, 5))
    eta = rng.standard_normal(25)
    got = one.step_with_noise(torch.as_tensor(x), torch.as_tensor(b), [[{"eta": torch.as_tensor(eta)}]])
    want = jone.step_with_noise(jnp.asarray(x), jnp.asarray(b), [[{"eta": jnp.asarray(eta)}]])
    assert _rel(got.numpy(), want) < 1e-12
    # the keyed step: x + the coarse sampler's keyed draw on b - A x
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    key, y = one.step(7, xt, bt)
    k, sub = keys.split(7)
    _, z = one.coarse.step(sub, torch.zeros_like(xt), bt - op.apply(xt))
    assert key == k and torch.equal(y, xt + z)
    st = init_chain(CholeskySampler.create(op), 3)
    assert st.x.shape == (5, 5) and st.x.device.type == DEV
