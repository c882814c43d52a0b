"""YAML config loading with recursive ``_base_`` file merge
(own copy of ``gm3d_tpu/config/config.py``; the port reads the same
files under ``configs/``)."""

from __future__ import annotations

import os
from typing import Any

import yaml


class ConfigDict(dict):
    """dict with attribute access (EasyDict/DotDict stand-in)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj


def merge_new_config(config: dict, new_config: dict, base_dir: str = ".") -> dict:
    """Recursive merge; a ``_base_`` string value pulls in another YAML file
    first (reference ``utils/config.py:18-38`` semantics)."""
    for key, val in new_config.items():
        if key == "_base_" and isinstance(val, str):
            path = val if os.path.isabs(val) else os.path.join(base_dir, val)
            with open(path) as f:
                base = yaml.safe_load(f)
            config.setdefault("_base_", {})
            merge_new_config(config["_base_"], base, os.path.dirname(path))
        elif isinstance(val, dict):
            config.setdefault(key, {})
            if not isinstance(config[key], dict):
                config[key] = {}
            merge_new_config(config[key], val, base_dir)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file: str) -> ConfigDict:
    with open(cfg_file) as f:
        new_config = yaml.safe_load(f)
    config: dict = {}
    merge_new_config(config, new_config, os.path.dirname(os.path.abspath(cfg_file)))
    return ConfigDict.wrap(config)
