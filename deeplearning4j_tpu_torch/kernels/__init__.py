"""Hand-written Hopper kernels (``csrc/``) with their wrappers and plain
PyTorch versions, plus plain-torch LayerNorm. Importing this package
builds nothing: a kernel is compiled at its first launch.

Re-exports ``bn_train_fused`` as the JAX package's ``kernels`` does. Its
``register_*`` / ``*_helper`` glue has no counterpart: the port's
kernels are the card's default route (``nn/helpers.py``)."""

from .batchnorm import bn_train_fused

__all__ = ["bn_train_fused"]
