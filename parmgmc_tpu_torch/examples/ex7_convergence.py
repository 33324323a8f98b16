"""ex7: overdispersed chains until R-hat converges.

The reference's ex7.c: 8 chains with inits scaled by 1e6, the
Gelman-Rubin R-hat of a scalar QOI recomputed every 50 samples until it
drops below 1.05.  The convergence statistic is selectable: the
reference's moment R-hat (``--method classic``) or the rank-normalized
split-R-hat with folding of Vehtari et al. 2021 (``--method rank``,
``diagnostics/rhat.py``).  Also reports bulk/tail ESS of the trace.  The
chains advance one at a time through the sampler's keyed step
(``chain.multi_chain``).

    python -m parmgmc_tpu_torch.examples.ex7_convergence [--grid 9] [--chains 8]
        [--method rank|classic] [--device cuda]
"""

import argparse
import time

import torch

from parmgmc_tpu_torch.diagnostics.rhat import ess_bulk, ess_tail, rhat_rank
from parmgmc_tpu_torch.diagnostics.stats import sample_until_converged
from parmgmc_tpu_torch.examples import add_device_flag, example_device
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=9)
    ap.add_argument("--kappa", type=float, default=1.0)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--method", default="rank", choices=("classic", "rank"))
    ap.add_argument("--check-every", type=int, default=50)
    ap.add_argument("--tol", type=float, default=1.05)
    ap.add_argument("--max-steps", type=int, default=100_000)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = example_device(args.device)

    op = shifted_laplace_fd((args.grid, args.grid), args.kappa, dtype=torch.float32, device=dev)
    smp = MGMCSampler.create(op, n_levels=2)
    b = torch.ones(op.grid_shape, dtype=torch.float32, device=dev)

    t0 = time.perf_counter()
    trace, steps, rhat = sample_until_converged(
        smp,
        b,
        lambda x: torch.mean(x),
        n_chains=args.chains,
        check_every=args.check_every,
        rhat_tol=args.tol,
        max_steps=args.max_steps,
        method=args.method,
    )
    chain_s = time.perf_counter() - t0
    print(
        f"converged after {steps} steps/chain: "
        f"{args.method} R-hat = {rhat:.4f} (tol {args.tol})"
    )
    rr, eb, et = rhat_rank(trace), ess_bulk(trace), ess_tail(trace)
    print(
        f"rank diagnostics on the trace: rhat_rank = {rr:.4f}, "
        f"ess_bulk = {eb:.0f}, ess_tail = {et:.0f} "
        f"of {trace.size} draws"
    )
    assert rhat < args.tol
    return dict(steps=steps, rhat=float(rhat), rhat_rank=float(rr), ess_bulk=float(eb), ess_tail=float(et),
                draws=int(trace.size), chain_s=chain_s)


if __name__ == "__main__":
    main()
