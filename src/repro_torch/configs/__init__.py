"""Configurations (port of ``repro/configs``): the paper's two-tower model
and the recsys shape set."""
