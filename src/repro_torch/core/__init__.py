"""Rotation primitives (port of ``repro/core``: givens, matching)."""
