"""The user-facing examples, run as ``python -m parmgmc_tpu_torch.examples.<name>``.

Each module is the port of the JAX package's script of the same name in
``examples/``: the same flags with the same defaults, the same printed
lines and the same acceptance asserts.  Each exposes ``main(argv=None)``,
which returns the numbers it prints as a dict, and takes one more flag,
``--device`` (default ``cuda``; ``--device cpu`` runs on the host).  A
run asked for the card on a host without one raises: no example moves to
the CPU by itself.  ``baseline_cpu_reference`` times the host alone and
has no ``--device``.

| Module | What it shows |
| --- | --- |
| ``ex1_samplers`` | every sampler type on the 2D shifted-Laplace mean-convergence test |
| ``ex2_matern_iact`` | the Matérn façade (33 x 33 grid or a Gmsh mesh), QOI IACT, VTK dump |
| ``ex4_posterior`` | posterior sampling (LRC operators) across samplers |
| ``ex7_convergence`` | overdispersed chains until R-hat converges, rank diagnostics |
| ``ex9_squared_prior`` | the (kappa^2 - Lap)^2 prior with patch-Gibbs smoothers |
| ``ex13_weak_scaling`` | weak scaling over shard slots: structured, chains, row-partitioned mesh |
| ``ex13_cholsampler`` | exact sparse-LDL^T sampling of the refined wrench, checked against MGMC |
| ``benchmark_matern`` | time a sample, IACT and time an independent sample on the mesh presets |
| ``baseline_cpu_reference`` | the CPU anchor: the reference's CSR SOR loop on one host core |
| ``make_meshes`` | rebuilds ``data/*.msh`` |

Importing a module runs nothing.
"""

import argparse

import torch


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda, the default, or cpu)")


def example_device(name: str) -> torch.device:
    """The device ``--device`` names; a CUDA device on a host without one
    raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available (pass --device cpu to run on the host)")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the host), so a timed
    region starts after the work before it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
