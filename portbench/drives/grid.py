"""Drive of the structured-grid GMRF configurations.

The program side: ``models.problems.gmrf_3d`` (optionally conditioned on
ball averages through ``models.obs.make_posterior_operator``), the MGMC
sampler the configuration names, and ``chain.sample_chain_deferred``, one
request being the next ``steps_per_request`` steps of the chain.  The
judge side: :mod:`portbench.reference.gmrf`, which follows the judged
requests from their starting states and keys (``harness.judge``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import gmrf as ref


def observations(traffic: dict, seed: int):
    """The ball observations of a posterior mix, drawn from ``seed``:
    centres 0.15 + 0.7 U, values N(0, 1); None for a prior."""
    obs = traffic.get("observations")
    if obs is None:
        return None
    rng = np.random.default_rng([seed, 0x0B5])
    k = int(obs["count"])
    return dict(
        sigma2=float(obs["sigma2"]),
        coords=0.15 + 0.7 * rng.random((k, 3)),
        radii=np.full(k, float(obs["radius"])),
        values=rng.standard_normal(k),
    )


class Drive:
    """One chain of the configuration's sampler, a request at a time."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from parmgmc_tpu_torch.chain import init_chain
        from parmgmc_tpu_torch.models.obs import make_posterior_operator
        from parmgmc_tpu_torch.models.problems import gmrf_3d
        from parmgmc_tpu_torch.samplers.mgmc import MGMCSampler

        if traffic.get("chains", 1) != 1:
            raise ValueError("the grid drive runs one chain")
        self.config, self.traffic = config, traffic
        self.steps = int(traffic["steps_per_request"])
        self.chains = 1
        self.obs = observations(traffic, seed)
        op = gmrf_3d(int(config["n"]), float(config["kappa"]), dtype=torch.float32, device=device)
        self.b = None
        if self.obs is not None:
            op, self.b = make_posterior_operator(op, self.obs["sigma2"], self.obs["coords"],
                                                 self.obs["radii"], obsvals=self.obs["values"])
        s = config["sampler"]
        self.sampler = MGMCSampler.create(
            op, n_pre=s["n_pre"], n_post=s["n_post"], coarsest_size=s["coarsest_size"],
            coarsening=s["coarsening"],
        )
        self.state = init_chain(self.sampler, int(seed))
        self.record = None

    def request(self) -> torch.Tensor:
        """The next ``steps`` steps; their QOI (the field mean) on the device."""
        from parmgmc_tpu_torch.chain import sample_chain_deferred

        start = self.state
        self.state, q = sample_chain_deferred(self.sampler, start, self.b, self.steps)
        # (start field, start key, end field): the chain's own tensors, no copy
        self.record = (start.x, start.key, self.state.x)
        return q

    def free(self):
        """Drop the program's sampler and chain (the judged records stay)."""
        self.sampler = self.state = self.b = self.record = None

    def reference(self, dtype, device, store=None):
        """The reference chain of this configuration and mix (``store``: the
        control's storage precision, see :class:`~portbench.reference.gmrf.Chain`)."""
        s = self.config["sampler"]
        if (s["n_pre"], s["n_post"], s["coarsening"]) != (1, 0, "aggregate"):
            raise ValueError("the grid reference follows the aggregate V(1,0) cycle")
        return ref.Chain(int(self.config["n"]), float(self.config["kappa"]), s["coarsest_size"],
                         dtype, device, obs=self.obs, store=store)
