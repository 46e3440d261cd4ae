"""The port's kernels: hand-written Hopper CUDA (``csrc/``), their loader
(``_build``), their plain PyTorch versions (``ref``) and the dispatching
wrappers (``ops``). Importing this package builds nothing."""
