"""ex2: Matérn field sampling with a QOI stream, IACT and a VTK dump.

The reference's ex2.c: the MS object end to end with a domain-mean QOI,
the IACT print, a mean ~ 0 check and VTK output of the mean and variance.

    python -m parmgmc_tpu_torch.examples.ex2_matern_iact [--mesh wrench] [--vtk out.vtk] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from parmgmc_tpu_torch.diagnostics.iact import iact
from parmgmc_tpu_torch.examples import add_device_flag, example_device
from parmgmc_tpu_torch.io import write_vtk_structured, write_vtk_unstructured
from parmgmc_tpu_torch.models.matern import MaternMeshSampler, MaternSampler

N_MEAN_VAR = 5_000  # steps of the mean/variance run (a constant of the JAX script too)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None, help="Gmsh file (else 33x33 grid)")
    ap.add_argument("--samples", type=int, default=20_000)
    ap.add_argument("--kappa", type=float, default=1.0)
    ap.add_argument("--vtk", default=None, help="output .vtk path")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    if args.mesh:
        ms = MaternMeshSampler(mesh_file=args.mesh, kappa=args.kappa, device=dev)
    else:
        ms = MaternSampler((33, 33), kappa=args.kappa, dtype=torch.float64, device=dev)
    ms.set_qoi(lambda x: torch.mean(x))

    t0 = time.perf_counter()
    q = ms.sample(args.samples, burnin=200).cpu().numpy()
    chain_s = time.perf_counter() - t0
    tau, valid = iact(q)
    print(f"QOI mean: {q.mean():+.5f} (expect ~0)")
    print(f"IACT: {tau:.3f} (valid: {valid})")
    assert abs(q.mean()) < 0.05

    mean, var = ms.sample_mean_and_var(N_MEAN_VAR)
    if args.vtk:
        if args.mesh:
            write_vtk_unstructured(args.vtk, ms.points, ms.cells, {"mean": mean, "var": var})
        else:
            write_vtk_structured(args.vtk, {"mean": mean, "var": var})
        print(f"wrote {args.vtk}")
    return dict(qoi_mean=float(q.mean()), tau=float(tau), valid=bool(valid), n=int(np.prod(mean.shape)),
                chain_s=chain_s, steps=args.samples + 200)


if __name__ == "__main__":
    main()
