"""gm3d_tpu_torch: the PyTorch/CUDA port of ``gm3d_tpu`` for an NVIDIA H100.

Same sub-packages and module names as the JAX package, so a reader finds the
counterpart of every file; PyTorch idiom inside. The package imports
``torch`` only: never ``jax`` or ``flax``, and nothing of ``gm3d_tpu``.

Ported so far (the serving path):

- ``gm3d_tpu_torch.ops``     FPS and exact KNN (hand-written CUDA kernels
  under ``csrc/``, built with ``nvcc`` at first use), grouping.
- ``gm3d_tpu_torch.models``  transformer blocks, PointTransformer classifier,
  the encoders of Point-MAE and the GM3D student.
- ``gm3d_tpu_torch.ckpt``    weights from the JAX package's variable trees.
- ``gm3d_tpu_torch.config``  YAML with ``_base_`` merge, model registry.
- ``gm3d_tpu_torch.serve``   ``.gm3dx`` artifacts, pad/chunk runner, dynamic
  batcher, HTTP server.
- ``gm3d_tpu_torch.cli``     ``export_model`` and ``serve``.

Entry points run on the GPU unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
