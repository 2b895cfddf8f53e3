"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``
for one NVIDIA H100 (Hopper, sm_90a).

The subpackages mirror the JAX package's layout and public names, so each
module has an obvious counterpart there:

- ``ops``      — activations, seeded init, the device-transfer seam.
- ``nn``       — configuration tier (the same JSON as the JAX package),
                 layers, vertices, ComputationGraph, the helper registry.
- ``kernels``  — hand-written Hopper kernels (``csrc/*.cu``, built with
                 nvcc at first use and bound with ctypes) beside their
                 plain PyTorch versions, plus plain-torch LayerNorm.
- ``models``   — the transformer LM, its KV-cache decoder and the slot
                 engine that serves it.
- ``utils``    — loading JAX checkpoints and parameters.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
