"""ex1: sampler mean-convergence on a 2D shifted-Laplace GMRF.

The reference's ex1.c: a 9x9 grid, kappa = 10, every sampler family, the
relative sample-mean error against a direct solve.

    python -m parmgmc_tpu_torch.examples.ex1_samplers [--sampler gibbs|gibbs-symmetric|cholesky|mgmc]
        [--samples 100000] [--grid 9] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from parmgmc_tpu_torch.chain import init_chain, sample_moments
from parmgmc_tpu_torch.examples import add_device_flag, example_device
from parmgmc_tpu_torch.models.problems import gmrf_2d
from parmgmc_tpu_torch.samplers.registry import build_sampler

CONFIGS = {
    "gibbs": {"type": "gibbs", "omega": 1.0, "sweep": "forward"},
    "gibbs-symmetric": {"type": "gibbs", "sweep": "symmetric"},
    "cholesky": {"type": "cholesky"},
    "mgmc": {"type": "mgmc", "n_pre": 1, "n_post": 1, "coarsest_size": 16},
}


def exact_mean(op) -> np.ndarray:
    """A^{-1} 1 by a dense solve, grid-shaped (the reference the sample mean
    is held to)."""
    A = op.to_dense().cpu().numpy()
    return np.linalg.solve(A, np.ones(op.n)).reshape(op.grid_shape)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sampler", default="mgmc", choices=sorted(CONFIGS))
    ap.add_argument("--samples", type=int, default=100_000)
    ap.add_argument("--burnin", type=int, default=1_000)
    ap.add_argument("--grid", type=int, default=9)
    ap.add_argument("--kappa", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    op = gmrf_2d(args.grid, kappa=args.kappa, dtype=torch.float64, device=dev)
    b = torch.ones(op.grid_shape, dtype=op.dtype, device=dev)
    sampler = build_sampler(op, dict(CONFIGS[args.sampler]))
    ex_mean = exact_mean(op)

    t0 = time.perf_counter()
    _, mean, _ = sample_moments(sampler, init_chain(sampler, args.seed), b, args.samples, burnin=args.burnin)
    mean = mean.cpu().numpy()
    chain_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(mean - ex_mean) / np.linalg.norm(ex_mean))
    print(f"sampler={args.sampler} samples={args.samples}")
    print(f"Rel. mean error: {rel:.5f}")
    assert rel < 0.05, "sample mean has not converged"
    return dict(sampler=args.sampler, samples=args.samples, rel=rel, chain_s=chain_s,
                steps=args.samples + args.burnin)


if __name__ == "__main__":
    main()
