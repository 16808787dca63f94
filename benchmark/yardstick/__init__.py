"""The yardstick of the port's benchmark: what a run measures and how.

Everything here belongs to the benchmark, not to the program under test:
the manifest and the files it names (``manifest``), the traffic generator
and the two loops that feed the program (``traffic``), one run of a cell
(``runner``), the trace reduction and the metric arithmetic (``trace``,
``stats``), the card's reading (``card``), the comparison that decides
``correct`` (``correct``) and the check that no JAX module is loaded
(``imports``).  ``program`` is the one module that calls into
``idto_tpu_torch``.
"""
