"""ex13: weak scaling over shard slots.

The reference's ex13.py: wrench-mesh weak scaling (refinements grow with
MPI ranks in {1, 8, 64, 512}), printing DOFs, wall time per sample, IACT
and time per independent sample.

Here the scaling axis is the shard slots of a :class:`~parmgmc_tpu_torch.
parallel.mesh.Mesh`: ``--devices N`` runs N slots, spread over the
machine's cards in turn (several slots share a card when it has fewer
than N; every line says how many of each).  Three modes:

* structured (default): the 3D GMRF grows with the slot count while the
  block a slot holds stays fixed, through ``parallel.mesh.shard_sampler``
  (the plain routes, ``min_local=4``);
* ``--unstructured``: one independent chain a slot on a mesh problem (a
  ``"chain"`` mesh axis), total ESS/sec over the chains;
* ``--unstructured --domain-decompose [--posterior]``: the wrench grows
  with the slot count (one refinement per 8x) and the row-partitioned
  MGMC of ``parallel.graph_sharded`` samples it.

    python -m parmgmc_tpu_torch.examples.ex13_weak_scaling --devices 1 2 4 8 --base 32 [--device cuda]
"""

import argparse
import math
import time

import numpy as np
import torch

from parmgmc_tpu_torch.chain import init_chain, sample_chain
from parmgmc_tpu_torch.diagnostics.iact import iact
from parmgmc_tpu_torch.examples import add_device_flag, example_device, synchronize
from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
from parmgmc_tpu_torch.parallel.mesh import make_mesh, shard_sampler
from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
from parmgmc_tpu_torch.samplers.registry import lax_variant


def slot_devices(dev: torch.device, n: int) -> list:
    """n slot devices: the cards in turn on CUDA, the host n times on the CPU."""
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        return [torch.device("cuda", i % cards) for i in range(n)]
    return [dev] * n


def _run_steps(step, key, xs, bs, n, qoi):
    """(key, xs, stacked QOI) after n keyed steps of ``step``."""
    q = []
    for _ in range(n):
        key, xs = step(key, xs, bs)
        q.append(qoi(xs))
    return key, xs, torch.stack(q)


def _timed_twice(run, dev):
    """JAX's compile-then-time pattern: one run to warm up, the second timed
    (the chain continues); (wall seconds, QOI of the timed run)."""
    run()
    synchronize(dev)
    t0 = time.perf_counter()
    q = run().cpu().numpy()
    return time.perf_counter() - t0, q


def run_config(n_dev: int, base: int, n_samples: int, kappa: float, dev) -> dict:
    shape = (base * n_dev, base, base)
    op = shifted_laplace_fd(shape, kappa, dtype=torch.float32, device=dev)
    smp = lax_variant(MGMCSampler.create(op, n_pre=1, n_post=1, coarsest_size=128))
    b = torch.zeros(shape, dtype=torch.float32, device=dev)
    N = op.n

    if n_dev > 1:
        mesh = make_mesh((n_dev,), axis_names=("x",), devices=slot_devices(dev, n_dev))
        sh, layout = shard_sampler(smp, mesh, min_local=4, grid_axes=("x", None, None))
        bs = layout.shard(b)
        state = [0, layout.shard(torch.zeros(shape, dtype=torch.float32, device=dev))]

        def qoi(xs):  # the global mean: the slots' blocks partition the grid
            return sum(p.sum().to(dev) for p in layout.pieces(xs).values()) / N

        def run():
            state[0], state[1], q = _run_steps(sh.step, state[0], state[1], bs, n_samples, qoi)
            return q
    else:
        st = [init_chain(smp, 0)]

        def run():
            st[0], q = sample_chain(smp, st[0], b, n_samples, extract=torch.mean)
            return q

    wall, q = _timed_twice(run, dev)
    tau, valid = iact(q)
    tau = max(float(tau), 1.0)
    tps = wall / n_samples * 1000
    print(
        f"devices={n_dev:3d} dofs={np.prod(shape):>12,} "
        f"time/sample={tps:8.2f} ms  IACT={tau:5.2f}{'' if valid else '*'} "
        f"time/indep-sample={tau * tps:8.2f} ms"
    )
    return dict(mode="structured", devices=n_dev, dofs=int(np.prod(shape)), ms_per_sample=tps, tau=tau,
                valid=bool(valid), ms_per_indep_sample=tau * tps)


def run_mesh_config(n_dev: int, n_refine: int, n_samples: int, kappa: float, dev) -> dict:
    """Unstructured weak scaling: slots run independent CHAINS.

    The reference's wrench ex13 grows the mesh with ranks under domain
    decomposition; graph sweeps are gather-bound, so the scaling axis for
    meshes here is independent chains (the reference runs chains
    serially).  One chain a slot (chain-major, split over a ``"chain"``
    mesh axis); the reported throughput is the TOTAL ESS/sec over the
    chains."""
    from parmgmc_tpu_torch.models.mesh import matern_precision_mesh, refine, unit_square_mesh
    from parmgmc_tpu_torch.operators.graph import from_csr

    pts, cells = unit_square_mesh(9)
    for _ in range(n_refine):
        pts, cells = refine(pts, cells)
    A = matern_precision_mesh(pts, cells, kappa)
    op = from_csr(A, dtype=torch.float32, device=dev)
    smp = MGMCSampler.create(op, coarsest_size=64)
    b = torch.zeros((op.n,), dtype=torch.float32, device=dev)
    qoi = lambda x: torch.mean(x, dim=0)  # noqa: E731  one mean a chain

    if n_dev > 1:
        mesh = make_mesh((n_dev,), axis_names=("chain",), devices=slot_devices(dev, n_dev))
        sh, layout = shard_sampler(smp, mesh)
        bs = layout.shard(b)
        state = [0, layout.shard(torch.zeros((op.n, n_dev), dtype=torch.float32, device=dev))]

        def run():
            state[0], state[1], q = _run_steps(sh.step, state[0], state[1], bs, n_samples,
                                               lambda xs: qoi(layout.unshard(xs, dev)))
            return q
    else:
        st = [init_chain(smp, 0, batch=(n_dev,))]

        def run():
            st[0], q = sample_chain(smp, st[0], b, n_samples, extract=qoi)
            return q

    wall, q = _timed_twice(run, dev)
    tau, valid = iact(q[:, 0])
    tau = max(float(tau), 1.0)
    tps = wall / n_samples * 1000
    total_ess = n_dev / (tau * wall / n_samples)
    print(
        f"devices={n_dev:3d} chains={n_dev} dofs={op.n:>9,} "
        f"time/sample={tps:8.2f} ms  IACT={tau:5.2f}{'' if valid else '*'} "
        f"total ESS/sec={total_ess:8.1f}"
    )
    return dict(mode="unstructured", devices=n_dev, dofs=op.n, ms_per_sample=tps, tau=tau, valid=bool(valid),
                total_ess_per_sec=total_ess)


def run_mesh_dd_config(
    n_dev: int,
    n_refine: int,
    n_samples: int,
    kappa: float,
    dev,
    posterior: bool = False,
    mesh_file: str = "wrench",
) -> dict:
    """Unstructured weak scaling under DOMAIN DECOMPOSITION on the 3D
    wrench: the mesh GROWS with the slot count (one refinement per 8x
    slots; 3D refinement multiplies nodes ~8x, so nodes a slot stay ~
    constant, the reference's ex13 semantics on the same geometry,
    ex13.py:80-87) and the row-partitioned sharded MGMC of
    ``parallel/graph_sharded.py`` samples it: level 0 sharded with
    per-colour NEIGHBOUR-WISE ghost exchanges (mc_sor.c:152-214), coarse
    levels replicated.

    ``posterior`` attaches ball-average observations and samples the LRC
    posterior under the same decomposition, the reference's MATLRC
    weak-scaling configuration (ex13.py:128-185)."""
    from parmgmc_tpu_torch.models.matern import MaternMeshSampler
    from parmgmc_tpu_torch.models.mesh import mesh_path, read_gmsh
    from parmgmc_tpu_torch.parallel.graph_sharded import make_sharded_graph_mgmc_step

    extra = max(0, round(math.log(max(n_dev, 1), 8)))
    obs = None
    if posterior:
        pts0, _ = read_gmsh(mesh_path(mesh_file))
        lo, hi = pts0.min(0), pts0.max(0)
        rel = np.array([[0.25, 0.5, 0.5], [0.5, 0.5, 0.5], [0.75, 0.5, 0.5]])
        coords = lo + rel * (hi - lo)
        radii = np.full(3, 0.12 * float(np.linalg.norm(hi - lo)))
        obs = dict(sigma2=0.1, coords=coords, radii=radii, values=[1.0, -1.0, 2.0])
    ms = MaternMeshSampler(
        mesh_file=mesh_file,
        kappa=kappa,
        refinements=n_refine + extra,
        dtype=torch.float32,
        observations=obs,
        coarsest_size=64,
        device=dev,
    )
    op = ms.op
    mesh = make_mesh((n_dev,), axis_names=("x",), devices=slot_devices(dev, n_dev))
    step, spec, layout = make_sharded_graph_mgmc_step(ms.sampler, mesh, coords=ms.dof_points)
    bl = layout.shard(ms.b)
    owned = float(spec.own_mask.sum())
    masks = [sl.own_mask.to(torch.float32) / owned for sl in spec.slots]
    state = [0, layout.shard(torch.zeros((op.n,), dtype=torch.float32, device=dev))]

    def qoi(xs):  # the global mean over the owned rows
        return sum((x * m).sum().to(dev) for x, m in zip(xs, masks))

    def run():
        state[0], state[1], q = _run_steps(step, state[0], state[1], bl, n_samples, qoi)
        return q

    wall, q = _timed_twice(run, dev)
    tau, valid = iact(q)
    tau = max(float(tau), 1.0)
    tps = wall / n_samples * 1000
    # ghost traffic: O(neighbours) received rows against the O(S) all_gather
    ghosts = spec.ghost_rows_received
    print(
        f"devices={n_dev:3d} ({'posterior ' if posterior else ''}"
        f"domain-decomposed {mesh_file}) dofs={op.n:>9,} "
        f"local={spec.n_local:>7,} "
        f"ghost-rows/exchange={ghosts:>6,} "
        f"(allgather would be {spec.n_shards * spec.bmax:>6,}; "
        f"shifts={list(spec.nbr_shifts)}) "
        f"time/sample={tps:8.2f} ms  IACT={tau:5.2f}{'' if valid else '*'} "
        f"ESS/sec={1000.0 / (tau * tps):8.1f}"
    )
    return dict(mode="posterior-dd" if posterior else "dd", devices=n_dev, dofs=op.n, local=spec.n_local,
                ghost_rows=ghosts, ms_per_sample=tps, tau=tau, valid=bool(valid), ess_per_sec=1000.0 / (tau * tps))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--base", type=int, default=32, help="per-device block edge")
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--kappa", type=float, default=1.0)
    ap.add_argument(
        "--unstructured",
        action="store_true",
        help="mesh problem, chains-over-devices scaling (wrench-style)",
    )
    ap.add_argument("--refine", type=int, default=1, help="mesh refinements")
    ap.add_argument(
        "--domain-decompose",
        action="store_true",
        help="unstructured weak scaling via row-partitioned sharded "
        "MGMC (mesh grows with devices) instead of chain parallelism",
    )
    ap.add_argument(
        "--posterior",
        action="store_true",
        help="with --domain-decompose: sample the LRC posterior "
        "(ball observations) under the decomposition (ex13.py:128-185)",
    )
    ap.add_argument(
        "--mesh", default="wrench", help="mesh asset for --domain-decompose"
    )
    add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = example_device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    rows = []
    for nd in args.devices:
        print(f"devices={nd}: {nd} shard slot(s) on {min(nd, cards)} {dev.type} device(s)")
        if args.unstructured and args.domain_decompose:
            rows.append(run_mesh_dd_config(
                nd, args.refine, args.samples, args.kappa, dev,
                posterior=args.posterior, mesh_file=args.mesh,
            ))
        elif args.unstructured:
            rows.append(run_mesh_config(nd, args.refine, args.samples, args.kappa, dev))
        else:
            rows.append(run_config(nd, args.base, args.samples, args.kappa, dev))
    return dict(rows=rows, cards=cards)


if __name__ == "__main__":
    main()
