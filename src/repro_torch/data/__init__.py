"""Synthetic data and the input pipeline (port of ``repro/data``:
``sift_like``, ``ClickLog`` and ``pipeline.Pipeline``)."""
