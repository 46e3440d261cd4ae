"""Models (port of ``repro/models``): parameter specs, the embedding
substrate, the two-tower retrieval model of the paper, and the serving half
of the decoder-only LM (``layers``, ``transformer``)."""
