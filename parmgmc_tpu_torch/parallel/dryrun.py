"""The multi-device dry run (port of ``dryrun_multichip`` in the JAX
package's ``__graft_entry__.py``): every sharded path once, at the JAX
dry run's shapes and tolerances, each against its single-device form.

1. ``shard_sampler``: a V(1,1) MGMC sampler on a ("chain", "x") mesh,
   its chains as a trailing chain axis split over "chain", one keyed
   step against the unsharded plain keyed step;
2. the sharded chain kernels (``parallel.fused``), prior, noise off,
   against ``step_with_noise`` with zero noises (5e-5);
3. the same on an LRC posterior (5e-5);
4. the frozen-halo Gibbs step (``parallel.sharded``): block interiors
   against the exact-halo step (1e-5);
5. the row-partitioned mesh MGMC (``parallel.graph_sharded``), noise off,
   against ``step_with_noise`` with zero noises (5e-5);
6. the same on a mesh LRC posterior (5e-5).

The slots are the mesh's devices: distinct cards by default (and a
machine with too few raises), ``devices=["cuda:0"] * n`` for n slots on
one card, ``["cpu"] * n`` on the host.  On CUDA slots blocks 2 and 3 run
the chain kernels; on CPU slots their plain twins.  One process runs
every slot, so no subprocess is needed.  Any miss raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["dryrun_multichip"]


def _mesh_factors(n: int):
    """Split n into (chain, x) factors, preferring a 2-way chain axis."""
    if n % 2 == 0 and n > 2:
        return 2, n // 2
    return 1, n


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _rel(got, want) -> float:
    return float((got.to(want.device) - want).abs().max() / want.abs().max())


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run one step of every sharded path over ``n_devices`` slots and
    check it against the single-device step; prints one line a block."""
    from parmgmc_tpu_torch.models.mesh import matern_precision_mesh, unit_square_mesh
    from parmgmc_tpu_torch.models.obs import make_observation_mats
    from parmgmc_tpu_torch.operators.graph import from_csr
    from parmgmc_tpu_torch.operators.lrc import LRCOperator
    from parmgmc_tpu_torch.operators.stencil import shifted_laplace_fd
    from parmgmc_tpu_torch.parallel.fused import _zeros, make_sharded_mgmc_step
    from parmgmc_tpu_torch.parallel.graph_sharded import make_sharded_graph_mgmc_step
    from parmgmc_tpu_torch.parallel.mesh import make_mesh, shard_array, shard_sampler, unshard
    from parmgmc_tpu_torch.parallel.sharded import make_sharded_gibbs_step
    from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler
    from parmgmc_tpu_torch.samplers.registry import lax_variant

    f32 = torch.float32
    n_chain, n_x = _mesh_factors(n_devices)
    mesh = make_mesh((n_chain, n_x), ("chain", "x"), devices=devices)
    mesh1d = make_mesh((n_devices,), ("x",), devices=devices)
    home = mesh1d.slots()[0]
    gen = torch.Generator(device=home).manual_seed(5)

    def randn(shape):
        return torch.randn(shape, generator=gen, dtype=f32, device=home)

    # ---- 1. shard_sampler: the grid over "x", the chains over "chain" --------
    n0 = max(16, 4 * n_x)
    n0 = math.ceil(n0 / (2 * n_x)) * 2 * n_x  # even blocks for the transfers
    op = shifted_laplace_fd((n0, 16, 16), 1.0, f32, device=home)
    sampler = MGMCSampler.create(op, n_levels=2, n_pre=1, n_post=1)
    sh, layout = shard_sampler(sampler, mesh, min_local=2, grid_axes=("x", None, None))
    n_chains = 2 * n_chain
    x0 = torch.zeros((*op.grid_shape, n_chains), dtype=f32, device=home)
    b = torch.zeros(op.grid_shape, dtype=f32, device=home)
    key, xs = sh.step(0, layout.shard(x0), layout.shard(b))
    x = layout.unshard(xs)
    _check(tuple(x.shape) == (*op.grid_shape, n_chains) and bool(torch.isfinite(x).all()),
           f"the shard_sampler step gave {tuple(x.shape)}")
    blocks = {k[1:] for k in sh.levels[0].keys}
    _check(len(blocks) == n_devices, f"expected {n_devices} distinct blocks, got {len(blocks)}")
    _, ref = lax_variant(sampler).step(0, x0, b)
    err = _rel(x, ref)
    _check(err < 1e-5, f"the shard_sampler step diverged from the unsharded step: {err}")
    print(f"shard_sampler V(1,1) OK: mesh (chain, x) = ({n_chain}, {n_x}), grid {op.grid_shape}, "
          f"{n_chains} chains, {n_devices} blocks, vs unsharded keyed step {err:.2e}"
          f"{' (bit for bit)' if torch.equal(x, ref) else ''}")

    # ---- 2. the sharded chain kernels, prior ----------------------------------
    n0 = 4 * n_devices * max(1, -(-32 // (4 * n_devices)))
    op_f = shifted_laplace_fd((n0, 32, 128), 1.0, f32, device=home)
    smp_f = MGMCSampler.create(op_f, n_levels=4, n_pre=1, n_post=0, coarsening="aggregate")
    _check(smp_f.n_levels == 4, f"{smp_f.n_levels} levels")
    step_f = make_sharded_mgmc_step(smp_f, mesh1d, min_local=4, with_noise=False)
    xf, bf = randn(op_f.grid_shape), randn(op_f.grid_shape)
    _, out = step_f(5, shard_array(xf, mesh1d), shard_array(bf, mesh1d))
    _check(len(out) == n_devices, f"{len(out)} blocks")
    ref = smp_f.step_with_noise(xf, bf, _zeros(smp_f.noise_shapes(), f32, home))
    err = _rel(unshard(out, device=home), ref)
    _check(err < 5e-5, f"sharded-fused cycle diverged from single-device: rel err {err}")
    print(f"sharded-fused parity OK: {n_devices} shards, grid {op_f.grid_shape}, 4 levels, rel err {err:.2e}")

    # ---- 3. the sharded chain kernels, LRC posterior --------------------------
    B, sigma_inv, f_obs = make_observation_mats(
        op_f.grid_shape, 0.05, np.array([[0.3, 0.5, 0.4], [0.7, 0.4, 0.6]]), np.full(2, 0.25),
        obsvals=np.ones(2), dtype=f32, device=home)
    smp_lrc = MGMCSampler.create(LRCOperator(base=op_f, B=B, sigma_inv=sigma_inv), n_levels=3, n_pre=1,
                                 n_post=0, coarsening="aggregate")
    step_lrc = make_sharded_mgmc_step(smp_lrc, mesh1d, min_local=4, with_noise=False)
    xl = randn(op_f.grid_shape)
    _, out = step_lrc(5, shard_array(xl, mesh1d), shard_array(f_obs, mesh1d))
    ref = smp_lrc.step_with_noise(xl, f_obs, _zeros(smp_lrc.noise_shapes(), f32, home))
    err = _rel(unshard(out, device=home), ref)
    _check(err < 5e-5, f"sharded-fused LRC cycle diverged from single-device: {err}")
    print(f"sharded-fused LRC (posterior) parity OK: {n_devices} shards, k=2, rel err {err:.2e}")

    # ---- 4. the frozen-halo sweep against the exact one -----------------------
    op_h = shifted_laplace_fd((8 * n_devices, 16), 10.0, f32, device=home)
    xh = randn(op_h.grid_shape)
    bh = torch.ones(op_h.grid_shape, dtype=f32, device=home)
    outs = {}
    for mode in ("frozen", "exact"):
        step_h = make_sharded_gibbs_step(op_h, mesh1d, omega=1.0, halo_mode=mode)
        _, o = step_h(9, shard_array(xh, mesh1d), shard_array(bh, mesh1d))
        outs[mode] = unshard(o, device=home)
    local = op_h.grid_shape[0] // n_devices
    interior = torch.ones(op_h.grid_shape[0], dtype=torch.bool, device=home)
    for s in range(n_devices):
        # frozen halos perturb a block's edge row and, through the red ->
        # black order, its neighbour: two rows an edge are left out
        for d in range(2):
            interior[s * local + d] = False
            interior[s * local + local - 1 - d] = False
    d_int = float((outs["frozen"][interior] - outs["exact"][interior]).abs().max())
    d_all = float((outs["frozen"] - outs["exact"]).abs().max())
    _check(bool(torch.isfinite(outs["frozen"]).all()), "the frozen-halo step is not finite")
    _check(d_int < 1e-5, f"frozen-halo interior diverged from exact-halo: {d_int}")
    print(f"frozen-halo (Hogwild) mode OK: {n_devices} shards, interior match {d_int:.2e}, "
          f"boundary delta {d_all:.2e}")

    # ---- 5. row-partitioned mesh MGMC ------------------------------------------
    pts, cells = unit_square_mesh(12)
    opg = from_csr(matern_precision_mesh(pts, cells, 7.0), dtype=f32, device=home)
    smp_g = MGMCSampler.create(opg, coarsest_size=16)
    xg = randn((opg.n,))
    bg = torch.ones(opg.n, dtype=f32, device=home)
    step_g, spec_g, lay_g = make_sharded_graph_mgmc_step(smp_g, mesh1d, coords=pts, with_noise=False)
    _, outg = step_g(11, lay_g.shard(xg), lay_g.shard(bg))
    _check(len(outg) == n_devices, f"{len(outg)} blocks")
    ref = smp_g.step_with_noise(xg, bg, _zeros(smp_g.noise_shapes(), f32, home))
    err = _rel(lay_g.unshard(outg, device=home), ref)
    _check(err < 5e-5, f"sharded mesh MGMC diverged from single-device: {err}")
    print(f"row-partitioned mesh MGMC parity OK: {n_devices} shards, {opg.n} nodes, {smp_g.n_levels} levels, "
          f"rel err {err:.2e}, ghosts={spec_g.ghost_mode}:{spec_g.nbr_shifts}")

    # ---- 6. the mesh posterior (LRC) under domain decomposition ----------------
    rng = np.random.default_rng(13)
    kobs = 3
    Bg = np.zeros((opg.n, kobs), np.float32)
    for j in range(kobs):
        sup = rng.choice(opg.n, size=7, replace=False)
        Bg[sup, j] = rng.standard_normal(7)
    lrc_g = LRCOperator(base=opg, B=torch.as_tensor(Bg, device=home),
                        sigma_inv=torch.as_tensor(rng.uniform(0.5, 2.0, kobs), dtype=f32, device=home))
    smp_gl = MGMCSampler.create(lrc_g, coarsest_size=16)
    step_gl, _, lay_gl = make_sharded_graph_mgmc_step(smp_gl, mesh1d, coords=pts, with_noise=False)
    _, outgl = step_gl(12, lay_gl.shard(xg), lay_gl.shard(bg))
    ref = smp_gl.step_with_noise(xg, bg, _zeros(smp_gl.noise_shapes(), f32, home))
    err = _rel(lay_gl.unshard(outgl, device=home), ref)
    _check(err < 5e-5, f"sharded mesh LRC MGMC diverged from single-device: {err}")
    print(f"mesh LRC (posterior) DD parity OK: {n_devices} shards, k={kobs}, rel err {err:.2e}")
