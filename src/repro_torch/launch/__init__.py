"""Launch layer (port of ``repro/launch``): the training launcher
(``launch.train``), the cells and the dry run (``launch.cells``,
``launch.dryrun``), and the meshes (``launch.mesh``: one card, and the data
mesh of the row-sharded searchers). The production meshes wait for a
multi-process backend (ROADMAP.md queue 1, item 11b)."""
