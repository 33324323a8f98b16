"""The benchmark of ``parmgmc_tpu_torch`` (see ``portbench/README.md``)."""
