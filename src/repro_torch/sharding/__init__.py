"""Sharding rule tables (port of ``repro/sharding``, the part the row-sharded
search reads)."""
