"""parmgmc_tpu_torch: the PyTorch + CUDA port of parmgmc_tpu.

Multigrid Monte Carlo sampling of high-dimensional Gaussians
N(A^{-1} b, A^{-1}) on one NVIDIA Hopper GPU.  The package mirrors the
JAX package's module names (``operators.stencil``, ``samplers.mgmc``,
``chain``, ``diagnostics.iact``, ...) so each module's counterpart is
easy to find; inside, it is plain PyTorch: dataclasses holding tensors,
a ``device`` on every constructor (``None``, the default, is the card:
pass ``device="cpu"`` for the host), explicit randomness (integer keys,
see :mod:`parmgmc_tpu_torch.keys`).

The level-0 chain down-phase and the smoothed coarse tail of the MGMC
V(1,0) cycle, and the full red/black Gibbs sweep of every other keyed
cycle and of the Gibbs chain, run as hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` at first use, see
:mod:`parmgmc_tpu_torch.kernels`).  Every kernel has a plain-torch twin
beside it; a wrapper runs the twin for CPU tensors and the kernel for
CUDA tensors.

This package never imports ``jax``.
"""

import torch

__version__ = "0.1.0"


def resolve_device(device) -> torch.device:
    """``device``, or the card when it is None: the entry points run on
    CUDA unless the caller asks for the CPU (no fallback when there is no
    card; torch raises on the first allocation)."""
    return torch.device("cuda" if device is None else device)
