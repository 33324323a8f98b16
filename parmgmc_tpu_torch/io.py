"""Checkpoints and VTK output (port of ``parmgmc_tpu.io``).

* A chain state is the pair (x, key) and round-trips through one ``.npz``
  file: ``x`` as written, the key (a Python int) as ``uint64``.
* VTK: legacy ASCII writers for structured grids (STRUCTURED_POINTS) and
  simplex meshes (UNSTRUCTURED_GRID).  They are numpy code and write, for
  the same fields, the bytes the JAX package's writers write.
"""

from __future__ import annotations

import numpy as np
import torch

from parmgmc_tpu_torch import resolve_device
from parmgmc_tpu_torch.chain import ChainState

__all__ = [
    "save_chain_state",
    "load_chain_state",
    "write_vtk_structured",
    "write_vtk_unstructured",
]


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_chain_state(path: str, state: ChainState) -> None:
    """Write (x, key) to ``path`` (numpy adds ``.npz`` when it is missing)."""
    np.savez(path, x=_host(state.x), key=np.asarray(int(state.key), dtype=np.uint64))


def load_chain_state(path: str, key: "int | None" = None, device=None) -> ChainState:
    """The chain state saved at ``path``, with x on ``device`` (the card
    when None).

    A file written by :func:`save_chain_state` carries its key.  A file
    written by the JAX package's ``save_chain_state`` carries x and a
    ``jax.random`` key, which names a threefry stream that this package
    cannot continue: its x is read and the chain's key must be given as
    ``key`` (passing ``key`` also replaces the key of a port file)."""
    d = np.load(path if path.endswith(".npz") else path + ".npz")
    x = torch.as_tensor(d["x"], device=resolve_device(device))
    if key is None:
        k = d["key"]
        if k.dtype != np.uint64 or k.shape != ():
            raise ValueError(
                f"{path} holds a JAX key ({k.dtype}, shape {k.shape}): its stream cannot be "
                "continued here; pass the chain's key as key=")
        key = int(k)
    return ChainState(x=x, key=int(key))


def write_vtk_structured(path: str, fields: dict) -> None:
    """Legacy VTK STRUCTURED_POINTS file with point-data fields (2D/3D)."""
    fields = {name: _host(v) for name, v in fields.items()}
    shapes = {tuple(v.shape) for v in fields.values()}
    if len(shapes) != 1:
        raise ValueError("all fields must share a grid shape")
    shape = shapes.pop()
    dims = tuple(shape) + (1,) * (3 - len(shape))
    n = int(np.prod(dims))
    sp = [1.0 / max(s - 1, 1) for s in dims]
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nparmgmc_tpu field\nASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
        f.write("ORIGIN 0 0 0\n")
        f.write(f"SPACING {sp[0]} {sp[1]} {sp[2]}\n")
        f.write(f"POINT_DATA {n}\n")
        for name, v in fields.items():
            arr = v.reshape(-1, order="F")
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            f.write("\n".join(f"{x:.10g}" for x in arr))
            f.write("\n")


def write_vtk_unstructured(path: str, points, cells, fields: dict) -> None:
    """Legacy VTK UNSTRUCTURED_GRID (tri = 5, tet = 10) with point data."""
    points = _host(points)
    cells = _host(cells)
    npts, d = points.shape
    k = cells.shape[1]
    ctype = 5 if k == 3 else 10
    pts3 = np.zeros((npts, 3))
    pts3[:, :d] = points
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nparmgmc_tpu mesh\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {npts} double\n")
        for p in pts3:
            f.write(f"{p[0]:.10g} {p[1]:.10g} {p[2]:.10g}\n")
        f.write(f"CELLS {len(cells)} {len(cells) * (k + 1)}\n")
        for c in cells:
            f.write(f"{k} " + " ".join(str(int(v)) for v in c) + "\n")
        f.write(f"CELL_TYPES {len(cells)}\n")
        f.write("\n".join([str(ctype)] * len(cells)))
        f.write(f"\nPOINT_DATA {npts}\n")
        for name, v in fields.items():
            arr = _host(v).ravel()
            f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
            f.write("\n".join(f"{x:.10g}" for x in arr))
            f.write("\n")
