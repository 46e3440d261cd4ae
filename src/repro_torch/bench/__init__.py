"""Ports of the JAX package's benchmark scripts, run on the card (or the
CPU with ``--device cpu``). Each prints its own JSON lines and writes no
file: ``python -m repro_torch.bench.fig3_table1_e2e``."""
