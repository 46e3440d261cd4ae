"""Frozen input generators, drawn from ``--seed``."""
