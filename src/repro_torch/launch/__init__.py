"""Launch layer (port of ``repro/launch``): the training launcher
(``launch.train``). The mesh, the dry-run and the cells wait for the
sharded slice and the zoo (ROADMAP.md queue 1, items 11 and 13)."""
