"""Sharding (port of ``repro/sharding``): the logical-axis rule tables and
their resolution (``rules``), and leaves laid over a mesh as their pieces
(``placed``)."""
