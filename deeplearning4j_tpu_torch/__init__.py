"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``
for one NVIDIA H100 (Hopper, sm_90a).

The subpackages mirror the JAX package's layout and public names, so each
module has an obvious counterpart there:

- ``ops``      — activations, seeded init, the device-transfer seam,
                 DataSet / MultiDataSet and the normalizers.
- ``nn``       — configuration tier (the same JSON as the JAX package),
                 layers, vertices, ComputationGraph, the helper registry.
- ``kernels``  — hand-written Hopper kernels (``csrc/*.cu``, built with
                 nvcc at first use and bound with ctypes) beside their
                 plain PyTorch versions, plus plain-torch LayerNorm.
- ``models``   — the transformer LM, its KV-cache decoder and the slot
                 engine that serves it.
- ``parallel`` — serving errors, fault injection and the engine
                 supervisor.
- ``observability`` — the numerics sentinel, KV-page checksums and the
                 serving tier's interval clock.
- ``eval``     — classification, regression, ROC and metadata
                 evaluation (numpy).
- ``optimize`` — training listeners.
- ``utils``    — loading JAX checkpoints and parameters.
- ``datasets`` — iterators (MNIST, Iris, CIFAR-10, LFW, Curves, DataVec
                 record readers) and the native C++ loader
                 (``csrc/dataloader.cpp``, built with g++ at first use).
- ``keras``    — Keras HDF5 import and export over the port's own HDF5
                 reader and writer, and the Keras backend server.
- ``nlp``      — SequenceVectors / Word2Vec / ParagraphVectors / GloVe on
                 the device (the tables' segment update a kernel on the
                 card), word-vector files, and the text tier: tokenizers,
                 CJK lattices, taggers, the tree parser, sentiment.
- ``graph_embeddings`` — graphs, random walks, DeepWalk and graph-vector
                 files.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
