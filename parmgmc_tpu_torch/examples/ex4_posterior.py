"""ex4: Bayesian posterior sampling with low-rank updates.

The reference's ex4.c: every sampler family on A + B Sigma^{-1} B^T
posteriors with ball observations; the posterior-mean error against a
direct solve under a tolerance.

    python -m parmgmc_tpu_torch.examples.ex4_posterior [--sampler gibbs|mgmc|woodbury] [--device cuda]
"""

import argparse
import time

import numpy as np
import torch

from parmgmc_tpu_torch.chain import init_chain, sample_moments
from parmgmc_tpu_torch.examples import add_device_flag, example_device
from parmgmc_tpu_torch.models.obs import make_posterior_operator
from parmgmc_tpu_torch.models.problems import gmrf_2d
from parmgmc_tpu_torch.samplers.registry import build_sampler

CONFIGS = {
    "gibbs": {"type": "gibbs", "omega": 1.0},
    "mgmc": {"type": "mgmc", "n_pre": 1, "n_post": 1, "coarsest_size": 32},
    "woodbury": {"type": "woodbury", "sampler": {"type": "cholesky"}},
}


def posterior_problem(device):
    """(op, f): gmrf_2d(17, 2) in float64 with the three ball observations."""
    base = gmrf_2d(17, kappa=2.0, dtype=torch.float64, device=device)
    return make_posterior_operator(
        base,
        sigma2=1e-2,
        coords=[[0.25, 0.25], [0.75, 0.75], [0.5, 0.3]],
        radii=[0.12, 0.1, 0.15],
        obsvals=[0.8, -0.5, 0.3],
    )


def posterior_mean(op, f) -> np.ndarray:
    """A_post^{-1} f by a dense solve, grid-shaped."""
    A = op.to_dense().cpu().numpy()
    return np.linalg.solve(A, f.cpu().numpy().ravel()).reshape(op.grid_shape)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sampler", default="mgmc", choices=sorted(CONFIGS))
    ap.add_argument("--samples", type=int, default=50_000)
    ap.add_argument("--tol", type=float, default=0.05)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    op, f = posterior_problem(dev)
    sampler = build_sampler(op, dict(CONFIGS[args.sampler]))
    mu = posterior_mean(op, f)

    t0 = time.perf_counter()
    _, mean, _ = sample_moments(sampler, init_chain(sampler, 1), f, args.samples, burnin=500)
    mean = mean.cpu().numpy()
    chain_s = time.perf_counter() - t0
    rel = float(np.linalg.norm(mean - mu) / np.linalg.norm(mu))
    print(f"sampler={args.sampler}: rel posterior mean error {rel:.4f}")
    assert rel < args.tol
    return dict(sampler=args.sampler, samples=args.samples, rel=rel, chain_s=chain_s, steps=args.samples + 500)


if __name__ == "__main__":
    main()
