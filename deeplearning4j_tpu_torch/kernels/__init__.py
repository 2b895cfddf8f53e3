"""Hand-written Hopper kernels (``csrc/``) with their wrappers and plain
PyTorch versions, plus plain-torch LayerNorm. Importing this package
builds nothing: a kernel is compiled at its first launch."""
