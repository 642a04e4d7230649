"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python skybench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything a
cell is made of is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
its deployment (clients, slots, limits) in ``cells/<workload>.json`` and
each metric's reader in ``metrics/<metric>.py``.  Nothing here imports
the JAX package or JAX.
"""
