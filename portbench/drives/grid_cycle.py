"""Drive of the structured-grid GMRF configurations on the general keyed
cycle: the linear-Galerkin hierarchy (``coarsening="linear"``).

The program side: ``models.problems.gmrf_3d``, the MGMC sampler the
configuration names, and ``chain.sample_chain`` with the field mean as
its QOI, one request being the next ``steps_per_request`` steps of the
chain.  The judge side: :mod:`portbench.reference.gmrf_galerkin`, which
follows the judged requests from their starting states and keys
(``harness.judge``).

The reference draws the 27-point levels' noise as the program's
Galerkin sweep kernel keys it, so the drive refuses, at build, a program
whose 27-point levels sweep on another route: such a program fails the
cell at once instead of running a window the reference cannot follow.
"""

from __future__ import annotations

import torch

from portbench.reference import gmrf_galerkin as ref

ROUTE = "fused_galerkin_sweep"  # the 27-point levels' sweep the reference follows


class Drive:
    """One chain of the configuration's sampler, a request at a time."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from parmgmc_tpu_torch.chain import init_chain
        from parmgmc_tpu_torch.models.problems import gmrf_3d
        from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

        if traffic.get("chains", 1) != 1 or traffic.get("observations") is not None:
            raise ValueError("the grid-cycle drive runs one chain of the prior")
        self.config, self.traffic = config, traffic
        self.steps = int(traffic["steps_per_request"])
        self.chains = 1
        s = config["sampler"]
        if s["coarsening"] != "linear":
            raise ValueError("the grid-cycle drive follows the linear-Galerkin hierarchy")
        op = gmrf_3d(int(config["n"]), float(config["kappa"]), dtype=torch.float32, device=device)
        self.sampler = MGMCSampler.create(
            op, n_pre=s["n_pre"], n_post=s["n_post"], coarsest_size=s["coarsest_size"],
            coarsening="linear", omega=float(s["omega"]),
        )
        routes = [getattr(m, "route", None) for m in self.sampler.smoothers[1:]]
        if any(r != ROUTE for r in routes):
            raise RuntimeError(f"the 27-point levels sweep on {routes}, not {ROUTE}: the reference "
                               "follows that kernel's noise")
        self.state = init_chain(self.sampler, int(seed))
        self.record = None

    def request(self) -> torch.Tensor:
        """The next ``steps`` steps; their QOI (the field mean) on the device."""
        from parmgmc_tpu_torch.chain import sample_chain

        start = self.state
        self.state, q = sample_chain(self.sampler, start, None, self.steps, extract=torch.mean)
        # (start field, start key, end field): the chain's own tensors, no copy
        self.record = (start.x, start.key, self.state.x)
        return q

    def free(self):
        """Drop the program's sampler and chain (the judged records stay)."""
        self.sampler = self.state = self.record = None

    def reference(self, dtype, device, store=None):
        """The reference chain of this configuration (``store``: the
        control's storage precision, see :class:`~portbench.reference.
        gmrf_galerkin.Chain`)."""
        s = self.config["sampler"]
        return ref.Chain(int(self.config["n"]), float(self.config["kappa"]), s["coarsest_size"],
                         s["n_pre"], s["n_post"], float(s["omega"]), dtype, device, store=store)
