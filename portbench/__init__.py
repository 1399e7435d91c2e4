"""The benchmark of ``ocean_bgc_tpu_torch``, the PyTorch and CUDA port.

One run of one cell: ``python3 -m portbench.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout,
on a machine with the card(s) the cell asks for.  ``BENCHMARK.json``
lists the cells; each names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``), and each metric has its
reader (``metrics/<name>.py``).  ``world.py`` makes the inputs from the
seed, ``program.py`` is the only module that imports the port,
``reference/`` is the plain reference and ``check.py`` the comparison
that decides ``correct``; ``control.py`` runs the control.  The CPU
tests: ``python -m pytest portbench/tests -q -p no:cacheprovider``.
"""
