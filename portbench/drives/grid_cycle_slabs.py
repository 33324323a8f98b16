"""Drive of the structured-grid GMRF prior on the general keyed cycle of
the aggregate hierarchy (``coarsening="aggregate"``), at sizes whose plain
reference is worked in slabs (``reference/gmrf_cycle_slabs.py``).

The program side is ``drives/grid_cycle.py``'s: ``models.problems.gmrf_3d``,
the MGMC sampler the configuration names, and ``chain.sample_chain`` with
the field mean as its QOI, one request being the next
``steps_per_request`` steps of the chain.  The judge side:
:mod:`portbench.reference.gmrf_cycle_slabs`, which follows the judged
requests from their starting states and keys (``harness.judge``).

The reference draws every smoothed level's noise as the program's keyed
red/black FD sweep keys it (``fused_rb_gibbs_sweep_fd``: #9 on planes past
the plane limit, #7 below, one hash convention), so the drive refuses, at
build, a program whose smoothed levels sweep otherwise: such a program
fails the cell at once instead of running a window the reference cannot
follow.
"""

from __future__ import annotations

import torch

from portbench.drives import grid_cycle
from portbench.reference import gmrf_cycle_slabs

ROUTE = "fused_rb_gibbs_sweep_fd"  # the smoothed levels' sweep the reference follows


class Drive(grid_cycle.Drive):
    """One chain of the configuration's sampler, a request at a time
    (``grid_cycle.Drive``'s requests on the aggregate hierarchy)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from parmgmc_tpu_torch.chain import init_chain
        from parmgmc_tpu_torch.models.problems import gmrf_3d
        from parmgmc_tpu_torch.operators.transfer import AggregateTransfer
        from parmgmc_tpu_torch.samplers.cholesky import CholeskySampler
        from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

        if traffic.get("chains", 1) != 1 or traffic.get("observations") is not None:
            raise ValueError("the grid-cycle drive runs one chain of the prior")
        self.config, self.traffic = config, traffic
        self.steps = int(traffic["steps_per_request"])
        self.chains = 1
        s = config["sampler"]
        if s["coarsening"] != "aggregate":
            raise ValueError("the slab-wise grid-cycle drive follows the aggregate hierarchy")
        op = gmrf_3d(int(config["n"]), float(config["kappa"]), dtype=torch.float32, device=device)
        self.sampler = MGMCSampler.create(
            op, n_pre=s["n_pre"], n_post=s["n_post"], coarsest_size=s["coarsest_size"],
            coarsening="aggregate", omega=float(s["omega"]),
        )
        smp = self.sampler
        routes = [(getattr(m, "route", None), getattr(m, "sweep", None)) for m in smp.smoothers]
        if any(r != (ROUTE, "forward") for r in routes) or smp.gamma != 1:
            raise RuntimeError(f"the smoothed levels sweep on {routes}, not forward {ROUTE}: the "
                               "reference follows that kernel's noise")
        if not (all(isinstance(t, AggregateTransfer) for t in smp.transfers)
                and isinstance(smp.coarse, CholeskySampler)):
            raise RuntimeError("the reference follows block-sum transfers and a Cholesky coarsest "
                               "level")
        self.state = init_chain(smp, int(seed))
        self.record = None

    def reference(self, dtype, device, store=None):
        """The slab-wise reference chain of this configuration (``store``:
        the control's storage precision, see :class:`~portbench.reference.
        gmrf_cycle_slabs.Chain`)."""
        s = self.config["sampler"]
        return gmrf_cycle_slabs.Chain(int(self.config["n"]), float(self.config["kappa"]),
                                      s["coarsest_size"], s["n_pre"], s["n_post"], float(s["omega"]),
                                      dtype, device, store=store)
