"""gm3d_tpu_torch: the PyTorch/CUDA port of ``gm3d_tpu`` for an NVIDIA H100.

Same sub-packages and module names as the JAX package, so a reader finds the
counterpart of every file; PyTorch idiom inside. The package imports
``torch`` only: never ``jax`` or ``flax``, and nothing of ``gm3d_tpu``.

Ported so far (the serving path and GM3D pretraining):

- ``gm3d_tpu_torch.ops``     FPS, exact KNN, the fused patch embed and the
  fused attention (hand-written CUDA kernels under ``csrc/``, built with
  ``nvcc`` at first use), grouping, Chamfer.
- ``gm3d_tpu_torch.models``  transformer blocks, PointTransformer classifier,
  Point-MAE and the GM3D student.
- ``gm3d_tpu_torch.ckpt``    weights from the JAX package's variable trees.
- ``gm3d_tpu_torch.config``  YAML with ``_base_`` merge, model and dataset
  registries.
- ``gm3d_tpu_torch.serve``   ``.gm3dx`` artifacts, pad/chunk runner, dynamic
  batcher, HTTP server.
- ``gm3d_tpu_torch.train``   the GM3D pretrain step, optimizer, schedules.
- ``gm3d_tpu_torch.data``    datasets, the host batcher, device prefetch,
  augmentations.
- ``gm3d_tpu_torch.cli``     ``export_model``, ``serve`` and ``pretrain``.

Entry points run on the GPU unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
