"""The plain reference: a scalar NumPy implementation of the coupled step
(surface fluxes, the 30-tracer ecosystem, carbonate chemistry, DMS and
MACROS, the forward-Euler update), one column and one cell at a time.

A frozen copy of the repository's test oracle, independent of the port
and of JAX, with the pH root-find replaced by the model's own iteration
(``carbonate.py``).  It imports nothing of the program, of the tests or
of the rest of the benchmark, and takes only the inputs the benchmark
makes: the world, the forcing records and the namelist.
"""
