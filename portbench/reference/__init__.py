"""Plain references that decide ``correct``.

Nothing here imports the program (``parmgmc_tpu_torch``), its JAX twin or
JAX: the keys and the counter noise are frozen copies of the program's
conventions, and every operator, observation and hierarchy is worked out
again from the inputs the benchmark made.
"""
