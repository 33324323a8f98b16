"""ex9: squared-operator prior with star-patch smoothers.

The reference's ex9.py: geometric MGMC on the C0-IP discretisation of
(kappa^2 - Lap)^2 with ASMStarPC patch smoothers whose sub-sub-PC is a
Cholesky sampler.  Here: the FD (kappa^2 - Lap)^2 radius-2 stencil, MGMC
with vertex-star block-Gibbs smoothers (batched per-patch Cholesky), and
the sample mean held to a direct solve.

    python -m parmgmc_tpu_torch.examples.ex9_squared_prior [--grid 17] [--samples 30000] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from parmgmc_tpu_torch.chain import init_chain, sample_moments
from parmgmc_tpu_torch.examples import add_device_flag, example_device
from parmgmc_tpu_torch.examples.ex1_samplers import exact_mean
from parmgmc_tpu_torch.models.problems import squared_shifted_laplace_fd
from parmgmc_tpu_torch.samplers.registry import build_sampler

CONFIG = {
    "type": "mgmc",
    "n_levels": 3,
    "smoother": {"type": "patch_gibbs"},
    "n_pre": 1,
    "n_post": 1,
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=17)
    ap.add_argument("--samples", type=int, default=30_000)
    ap.add_argument("--kappa", type=float, default=2.0)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    op = squared_shifted_laplace_fd((args.grid, args.grid), args.kappa, dtype=torch.float64, device=dev)
    sampler = build_sampler(op, dict(CONFIG))
    b = torch.ones(op.grid_shape, dtype=op.dtype, device=dev)
    mu = exact_mean(op)

    t0 = time.perf_counter()
    _, mean, _ = sample_moments(sampler, init_chain(sampler, 0), b, args.samples, burnin=300)
    mean = mean.cpu().numpy()
    chain_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(mean - mu) / np.linalg.norm(mu))
    print(f"(kappa^2-Lap)^2 prior, patch-smoothed MGMC: rel mean err {rel:.4f}")
    assert rel < 0.05
    return dict(samples=args.samples, rel=rel, chain_s=chain_s, steps=args.samples + 300)


if __name__ == "__main__":
    main()
