"""Training (port of ``repro/training``): AdamW with the rotation learner
routed to the manifold leaves, and the train-step builder."""
