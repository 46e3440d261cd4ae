"""Synthetic data (port of ``repro/data``: ``sift_like``)."""
