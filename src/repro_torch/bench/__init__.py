"""Ports of the JAX package's benchmark scripts, run on the card (or the
CPU with ``--device cpu``). Each prints its own JSON lines:
``python -m repro_torch.bench.fig3_table1_e2e``. Only ``serve_load`` and
``run`` write a file, a ``BENCH_torch_*.json`` trajectory, and only into
``--out`` or ``$REPRO_BENCH_DIR``."""
