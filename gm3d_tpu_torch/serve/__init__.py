"""Export + serving (the deployment surface of the port).

Surfaces:
  - :mod:`gm3d_tpu_torch.serve.export`  artifact format, save/load
  - :mod:`gm3d_tpu_torch.serve.runner`  :class:`ServingModel` (pad/chunk)
  - :mod:`gm3d_tpu_torch.serve.batcher` :class:`DynamicBatcher` (coalesce
    concurrent requests into shared device calls)
  - :mod:`gm3d_tpu_torch.serve.server`  stdlib HTTP micro-server
  - CLIs: ``gm3d_tpu_torch.cli.export_model``, ``gm3d_tpu_torch.cli.serve``
"""

from gm3d_tpu_torch.serve.batcher import DynamicBatcher  # noqa: F401
from gm3d_tpu_torch.serve.export import (  # noqa: F401
    build_classifier_fn,
    build_feature_fn,
    load_artifact,
    save_artifact,
)
from gm3d_tpu_torch.serve.runner import ServingModel  # noqa: F401
