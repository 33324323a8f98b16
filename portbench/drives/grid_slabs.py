"""Drive of the structured-grid GMRF prior at sizes whose plain reference
is worked in slabs (``reference/gmrf_slabs.py``): the program side is
``drives/grid.py``'s, one chain of ``sample_chain_deferred``; only the
reference differs.  The slab reference follows the prior alone."""

from __future__ import annotations

from portbench.drives import grid
from portbench.reference import gmrf_slabs


class Drive(grid.Drive):
    """``grid.Drive`` judged by the slab-wise reference."""

    def reference(self, dtype, device, store=None):
        """The slab-wise reference chain of this configuration (``store``:
        the control's storage precision)."""
        s = self.config["sampler"]
        if (s["n_pre"], s["n_post"], s["coarsening"]) != (1, 0, "aggregate"):
            raise ValueError("the grid reference follows the aggregate V(1,0) cycle")
        return gmrf_slabs.Chain(int(self.config["n"]), float(self.config["kappa"]), s["coarsest_size"],
                                dtype, device, obs=self.obs, store=store)
