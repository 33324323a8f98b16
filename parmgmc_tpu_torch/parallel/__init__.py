"""Sampling over several devices (port of ``parmgmc_tpu.parallel``).

One process drives every shard: a :class:`~.mesh.Mesh` is a named grid of
shard slots over a list of devices (distinct cards by default; several
slots may share one card when the caller says so), grid-shaped state is
held as a list of per-shard blocks, and the halo exchange, the sums and
the gathers of :mod:`.mesh` copy between the slots' devices.
:mod:`.sharded` is the plain-torch red/black Gibbs sweep on such blocks;
:mod:`.fused` runs the MGMC chain step on them through the chain and
sweep kernels with global-row keying; :func:`.mesh.shard_sampler` runs
any structured Gibbs or MGMC sampler's plain step on blocks with the
halos written out (:mod:`.spmd`); :mod:`.graph_sharded` row-partitions
an unstructured mesh's hierarchy; :mod:`.dryrun` drives every path once.
"""
