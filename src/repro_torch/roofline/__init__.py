"""Roofline model of one H100 (port of ``repro/roofline``)."""
