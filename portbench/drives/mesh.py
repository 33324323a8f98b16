"""Drive of the unstructured-mesh Matérn configurations.

The program side: ``models.matern.MaternMeshSampler`` on the
configuration's mesh, refinements, kappa and observations, with its
algebraic hierarchy, and the mean over the configuration's box as the
QOI; a request is the next ``steps_per_request`` steps of one chain
(``sample``) or of C chains chain-major (``sample_chains``).  The judge
side: :mod:`portbench.reference.mesh`, which follows the judged requests
from their starting states and keys."""

from __future__ import annotations

import os

import torch

from portbench.reference import mesh as ref

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mesh_file(config: dict) -> str:
    """The configuration's mesh, kept beside it (read by the program and
    the reference alike)."""
    return os.path.join(PKG, "configs", f"{config['mesh']}.msh")


class Drive:
    """C chains of the configuration's posterior sampler, a request at a time."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from parmgmc_tpu_torch.models.matern import MaternMeshSampler, observations_of, region_qoi

        self.config, self.traffic = config, traffic
        self.steps = int(traffic["steps_per_request"])
        self.chains = int(traffic["chains"])
        s = config["sampler"]
        self.ms = MaternMeshSampler(
            mesh_file=mesh_file(config), refinements=int(config["refinements"]),
            kappa=float(config["kappa"]), observations=observations_of(config["preset"]),
            dtype=getattr(torch, config["dtype"]), seed=int(seed), hierarchy=s["hierarchy"],
            coarsest_size=s["coarsest_size"], n_pre=s["n_pre"], n_post=s["n_post"], device=device,
        )
        w = torch.as_tensor(region_qoi(self.ms.points, config["preset"]), device=self.ms.b.device)
        self.ms.set_qoi(lambda x: x @ w)
        self.record = None

    def _state(self):
        if self.chains == 1:
            return self.ms.state
        return self.ms._chain_states.get(self.chains)

    def request(self) -> torch.Tensor:
        """The next ``steps`` steps; their QOI ((C, steps) or (steps,)) on the device."""
        start = self._state()
        if self.chains == 1:
            q = self.ms.sample(self.steps)
        else:
            q = self.ms.sample_chains(self.steps, self.chains)
        if start is None:  # the chain-major states are made on the first call
            from parmgmc_tpu_torch.chain import init_chain
            from parmgmc_tpu_torch import keys

            start = init_chain(self.ms.sampler, keys.fold_in(self.ms.state.key, self.chains),
                               batch=(self.chains,))
        end = self._state()
        self.record = (start.x, start.key, end.x)
        return q

    def free(self):
        self.ms = self.record = None

    def reference(self, dtype, device, store=None):
        if store is not None:
            raise ValueError("the mesh reference stores in the precision it computes in")
        p, s = self.config["preset"], self.config["sampler"]
        obs = dict(sigma2=p["sigma2"], coords=p["obs_coords"], radii=p["obs_radii"], values=p["obs_values"])
        return ref.Chain(mesh_file(self.config), int(self.config["refinements"]), float(self.config["kappa"]),
                         obs, (p["qoi_start"], p["qoi_end"]), s["coarsest_size"], dtype, device)
