"""Ports of the JAX package's example scripts (``examples/quickstart.py``,
``serve_ann.py``, ``train_twotower.py``; ``examples/gnn_index.py`` is
``repro_torch.bench.gnn_index``), run on the card or, with ``--device
cpu``, on the CPU: ``python -m repro_torch.examples.quickstart``. Each
prints what its JAX script prints and its ``main`` returns those numbers
as a dict. Their data come from ``torch.Generator``s, not JAX keys, so
their numbers are the port's own (ROADMAP.md, parity hazards, "PRNG")."""
