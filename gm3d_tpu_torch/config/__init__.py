"""Config system: YAML with recursive ``_base_`` merge + the model and dataset registries."""

from gm3d_tpu_torch.config.config import ConfigDict, cfg_from_yaml_file, merge_new_config
from gm3d_tpu_torch.config.registry import DATASETS, MODELS, Registry, build_model_from_cfg

__all__ = [
    "ConfigDict",
    "cfg_from_yaml_file",
    "merge_new_config",
    "Registry",
    "MODELS",
    "DATASETS",
    "build_model_from_cfg",
]
