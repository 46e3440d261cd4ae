"""IVF-PQ index: build (``ivf``), search (``search``) and rotation refresh
(``maintain``) — port of ``repro/index``."""
