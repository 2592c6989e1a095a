"""The benchmark of ``die_tpu_torch`` on one NVIDIA card.

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything a cell
needs is found by name: its configuration in ``configs/``, its traffic mix
in ``traffic/``, the mix's driver in ``drivers/`` and each per-layer metric's
reader in ``metrics/``.  ``reference/`` is the plain PyTorch reference that
decides ``correct``; it imports nothing of the program.
"""
