"""Models (port of ``repro/models``): parameter specs, the embedding
substrate and the two-tower retrieval model of the paper."""
