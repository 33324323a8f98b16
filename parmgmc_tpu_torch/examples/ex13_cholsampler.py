"""ex13's cholsampler baseline: standalone large-n exact sampling.

The reference's ex13.py:29-30 runs ``-pc_type cholsampler`` (a sparse
Pardiso factorization, pc_chols.c:17-27) standalone on the refined wrench
mesh as the exact baseline MGMC is compared against.  This drives the
port's equivalent, :class:`SparseCholeskySampler` (a sparse LDL^T on the
host), on the same mesh at 100k+ DOFs, checks three probe variances
against their exact values, and cross-validates MGMC posterior moments
against it (the MGMC chain runs on ``--device``).

    python -m parmgmc_tpu_torch.examples.ex13_cholsampler --refine 4 --samples 64
    python -m parmgmc_tpu_torch.examples.ex13_cholsampler --refine 3 --samples 256 --mgmc-samples 2000
"""

import argparse
import time

import numpy as np
import torch
from scipy.linalg import cho_solve

from parmgmc_tpu_torch.chain import ChainState, sample_chain
from parmgmc_tpu_torch.diagnostics.iact import iact
from parmgmc_tpu_torch.examples import add_device_flag, example_device
from parmgmc_tpu_torch.models.mesh import (
    matern_precision_mesh,
    mesh_observation_mats,
    mesh_path,
    read_gmsh,
    refine,
)
from parmgmc_tpu_torch.operators.graph import from_csr
from parmgmc_tpu_torch.operators.lrc import LRCOperator
from parmgmc_tpu_torch.samplers.cholesky import SparseCholeskySampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="wrench")
    p.add_argument("--refine", type=int, default=4)
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--kappa", type=float, default=1.0)
    p.add_argument("--nobs", type=int, default=4)
    p.add_argument(
        "--mgmc-samples", type=int, default=0,
        help="if > 0, run an MGMC chain and cross-validate probe "
        "means/variances against the exact sampler",
    )
    add_device_flag(p)
    args = p.parse_args(argv)
    dev = example_device(args.device)

    out = {}
    pts, cells = read_gmsh(mesh_path(args.mesh))
    for _ in range(args.refine):
        pts, cells = refine(pts, cells)
    t0 = time.perf_counter()
    A = matern_precision_mesh(pts, cells, args.kappa)
    t_asm = time.perf_counter() - t0
    op = from_csr(A, dtype=torch.float64, device=dev)
    n = op.n
    print(f"mesh: {args.mesh} refine={args.refine}  n={n}  nnz={A.nnz}")
    print(f"assembly: {t_asm:.1f} s")

    # posterior: ball-average observations on the mesh (obs.c analogue)
    rng = np.random.default_rng(0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    centers = lo + (0.2 + 0.6 * rng.random((args.nobs, pts.shape[1]))) * (hi - lo)
    radius = 0.15 * float((hi - lo).max())
    B, sigma_inv, f = mesh_observation_mats(
        pts, cells, 0.05, centers, np.full(args.nobs, radius),
        obsvals=rng.standard_normal(args.nobs),
    )
    # internal (colour-blocked) ordering of the graph operator
    perm = op.perm.cpu().numpy()
    Bi = torch.as_tensor(np.asarray(B)[perm], dtype=torch.float64, device=dev)
    fi = torch.as_tensor(np.asarray(f)[perm], dtype=torch.float64, device=dev)
    lrc = LRCOperator(base=op, B=Bi, sigma_inv=torch.as_tensor(sigma_inv, dtype=torch.float64, device=dev))

    t0 = time.perf_counter()
    smp = SparseCholeskySampler.create(lrc)
    t_fac = time.perf_counter() - t0
    print(f"sparse LDL^T factorization: {t_fac:.1f} s  "
          f"(nnz(L) = {smp._lu.L.nnz})")

    t0 = time.perf_counter()
    xs = smp.sample(7, args.samples, b=fi).reshape(args.samples, n).cpu().numpy()
    t_smp = (time.perf_counter() - t0) / args.samples
    print(f"{args.samples} exact posterior samples: {t_smp * 1e3:.1f} ms/sample "
          f"(i.i.d. -> {1.0 / t_smp:.1f} ESS/sec host-side)")
    out.update(n=n, nnz=int(A.nnz), assembly_s=t_asm, factor_s=t_fac, nnz_L=int(smp._lu.L.nnz),
               ms_per_exact_sample=t_smp * 1e3, probes=[])

    mu = smp.mean(fi).reshape(-1).cpu().numpy()
    probes = [rng.standard_normal(n) / np.sqrt(n) for _ in range(3)]
    print("probe validation (g^T x): exact vs sample estimates")
    for i, g in enumerate(probes):
        proj = xs @ g
        # exact probe variance g^T A_post^{-1} g via the factor + Woodbury
        lr = smp._lrc
        Aig = smp._lu.solve(g)
        want = float(
            g @ Aig - (g @ lr["C"]) @ cho_solve((lr["M_cho"], True), lr["B"].T @ Aig)
        )
        got_m, got_v = float(proj.mean()), float(proj.var(ddof=1))
        z = abs(got_m - g @ mu) / np.sqrt(want / args.samples)
        dv = abs(got_v - want) / want
        print(f"  probe {i}: mean z={z:.2f}  var rel err={dv:.3f} "
              f"(MC SE ~{np.sqrt(2.0 / args.samples):.3f})")
        out["probes"].append(dict(z=float(z), var_rel_err=float(dv)))
        assert z < 5.0 and dv < 6 * np.sqrt(2.0 / args.samples)

    if args.mgmc_samples > 0:
        t0 = time.perf_counter()
        mg = MGMCSampler.create(lrc, n_pre=1, n_post=1, coarsest_size=512)
        print(f"MGMC algebraic hierarchy: {time.perf_counter() - t0:.1f} s, "
              f"{mg.n_levels} levels")
        gmat = torch.as_tensor(np.stack(probes, axis=1), device=dev)  # (n, 3)
        st = ChainState(x=torch.zeros((n,), dtype=torch.float64, device=dev), key=1)
        t0 = time.perf_counter()
        _, q = sample_chain(mg, st, fi, args.mgmc_samples, extract=lambda x: x.reshape(-1) @ gmat, burnin=50)
        q = q.cpu().numpy()
        t_mg = (time.perf_counter() - t0) / args.mgmc_samples

        print(f"MGMC: {t_mg * 1e3:.1f} ms/cycle ({args.mgmc_samples} samples)")
        print("cross-validation MGMC vs exact cholsampler:")
        out.update(mgmc_levels=mg.n_levels, mgmc_ms_per_cycle=t_mg * 1e3, cross=[])
        for i, g in enumerate(probes):
            tau, _ = iact(q[:, i])
            neff = args.mgmc_samples / max(tau, 1.0)
            m_mg, v_mg = float(q[:, i].mean()), float(q[:, i].var(ddof=1))
            proj = xs @ g
            want = float(proj.var(ddof=1))
            z = abs(m_mg - g @ mu) / np.sqrt(want / neff)
            dv = abs(v_mg - want) / want
            print(f"  probe {i}: tau={tau:.2f}  mean z={z:.2f}  "
                  f"var rel diff={dv:.3f}")
            out["cross"].append(dict(tau=float(tau), z=float(z), var_rel_diff=float(dv)))
            assert z < 5.0, "MGMC mean disagrees with exact sampler"
        print("cross-validation OK")
    return out


if __name__ == "__main__":
    main()
