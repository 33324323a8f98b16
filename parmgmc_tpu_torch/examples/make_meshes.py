"""Generate the repo's own mesh assets (data/*.msh).

The reference ships CAD-derived Gmsh meshes (its ``data/{wrench,lshape,
piece,cuboid_hole}.msh``); this repo generates equivalent *classes* of
geometry from implicit regions (masked Kuhn-subdivided grids +
deterministic jitter, ``models.mesh.masked_grid_mesh``) so the mesh half
of the test suite and all benchmark presets work with no reference
mount.  The geometries live in the SAME coordinate frames as the
reference assets (the benchmark presets' observation balls and QOI
regions are absolute coordinates: wrench y up to ~256, piece centred
near the origin, cuboid 10x10x2; a repo asset in a different frame would
put every observation outside the material).  Node/cell counts are of
the same order of magnitude as the reference assets:

    wrench       3D   199 nodes /   368 tets   (ref: 171 / 356)
    lshape       2D   455 nodes /   794 tris   (ref: 408 / 734)
    piece        3D  4091 nodes / 17550 tets   (ref: 4177 / 14127)
    cuboid_hole  3D   140 nodes /   320 tets   (ref: 104 / 255)

The files it writes equal the checked-in ``data/*.msh`` byte for byte.

    python -m parmgmc_tpu_torch.examples.make_meshes [--outdir data]
"""

import argparse
import os

import numpy as np

from parmgmc_tpu_torch.models.mesh import (
    assemble_p1,
    masked_grid_mesh,
    write_gmsh,
)


def wrench():
    """3D wrench-ish solid in the REFERENCE asset's frame (x ~ +-26,
    y ~ -24..256, z ~ +-5): a handle bar joining an open-end head at
    y=0 and a ring head at y=230.  The wrench.json preset's observation
    balls ([0,240,0] r=20 on the ring, [0,130,0] r=8 on the handle,
    [15,-8,0] r=15 on the open head) and rect QOI all land inside."""

    def inside(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        handle = (np.abs(x) < 13) & (y > 10) & (y < 212) & (np.abs(z) < 5)
        head1 = (x**2 + y**2 < 29**2) & (np.abs(z) < 5)
        jaw = (np.abs(x) < 9) & (y < -4)  # open jaw slot
        head1 &= ~jaw
        head2 = (x**2 + (y - 230.0) ** 2 < 26**2) & (np.abs(z) < 5)
        hole2 = x**2 + (y - 230.0) ** 2 < 11**2
        head2 &= ~hole2
        return handle | head1 | head2

    return masked_grid_mesh(
        [[-32, 32], [-32, 258], [-5.5, 5.5]], 12.0, inside, jitter=0.12
    )


def lshape():
    """2D L-shaped domain: [0,2]^2 minus the open top-right quadrant."""

    def inside(p):
        x, y = p[:, 0], p[:, 1]
        return (x < 2.0) & (y < 2.0) & ~((x > 1.0) & (y > 1.0))

    return masked_grid_mesh([[0, 2], [0, 2]], 2.0 / 23, inside, jitter=0.18)


def piece():
    """3D machined plate in the reference piece's frame (origin-centred
    ~3.4 x 3.6 x 0.6 slab): three bores and corner chamfers, placed
    away from the piece.json preset's observation balls."""

    def inside(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        plate = (
            (x > -1.58) & (x < 1.8) & (np.abs(y) < 1.78)
            & (z > -0.2) & (z < 0.4)
        )
        bore1 = (x - 0.9) ** 2 + y**2 < 0.25**2
        bore2 = (x + 0.9) ** 2 + (y - 0.9) ** 2 < 0.2**2
        bore3 = (x + 0.9) ** 2 + (y + 0.9) ** 2 < 0.2**2
        chamfer = (x + np.abs(y)) > 3.2
        return plate & ~bore1 & ~bore2 & ~bore3 & ~chamfer

    return masked_grid_mesh(
        [[-1.62, 1.84], [-1.82, 1.82], [-0.23, 0.43]], 0.14, inside,
        jitter=0.1,
    )


def cuboid_hole():
    """3D 10x10x2 slab (the reference cuboid's frame) minus a z bore."""

    def inside(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        return (
            (x < 10.0) & (y < 10.0) & (z < 2.0)
            & ((x - 5.0) ** 2 + (y - 5.0) ** 2 > 2.8**2)
        )

    return masked_grid_mesh(
        [[0, 10], [0, 10], [0, 2]], 1.7, inside, jitter=0.1
    )


GEOMETRIES = {
    "wrench": wrench,
    "lshape": lshape,
    "piece": piece,
    "cuboid_hole": cuboid_hole,
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--outdir", default=os.path.join(root, "data"))
    args = ap.parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    out = {}
    for name, fn in GEOMETRIES.items():
        pts, cells = fn()
        # sanity: connected-ish, assemblable, SPD-able mesh
        K, M = assemble_p1(pts, cells)
        lumped = np.asarray(M.sum(axis=1)).ravel()
        assert (lumped > 0).all(), f"{name}: degenerate mass row"
        path = os.path.join(args.outdir, f"{name}.msh")
        write_gmsh(path, pts, cells)
        print(
            f"{name:12s} {pts.shape[0]:6d} nodes  {cells.shape[0]:6d} "
            f"{'tris' if cells.shape[1] == 3 else 'tets'}  -> {path}"
        )
        out[name] = dict(nodes=int(pts.shape[0]), cells=int(cells.shape[0]), path=path)
    return out


if __name__ == "__main__":
    main()
