"""Write small on-disk datasets of synthetic clouds in the layouts the port's
readers take (``data/datasets.py``), and a pretrain config that reads them.

  - ShapeNet-55 (the pretrain set): ``{subset}.txt`` lists of
    ``{taxonomy}-{model}.npy`` and one (points, 3) float32 ``.npy`` a model;
  - ModelNet40 (the SVM probe's sets): the shape-name and split lists and
    the ``modelnet40_{split}_8192pts_fps.dat`` cache the reader loads in
    place of its FPS preprocessing (synthetic labelled clouds of
    ``SyntheticClouds``);
  - ShapeNetPart (the seg set): the category table, the split lists and one
    ``x y z nx ny nz part`` text file an item.

Everything is drawn from ``--seed``. The native loader reads the ShapeNet-55
``.npy`` files and the ShapeNetPart ``.npy`` caches::

  python -m gm3d_tpu_torch.scripts.make_disk_datasets --out /tmp/disk --seed 0
  python -m gm3d_tpu_torch.cli.pretrain --config /tmp/disk/pretrain.yaml --native_loader ...
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict

import numpy as np
import yaml

from gm3d_tpu_torch.data.datasets import SEG_CLASSES, SyntheticClouds

SHAPENET_TAXONOMIES = ("02691156", "02747177", "02773838", "02801938")


def write_shapenet55(root: str, n_train: int, n_test: int, points: int, seed: int) -> Dict:
    """ShapeNet-55's layout under ``root``: ``DATA_PATH`` (the lists) and
    ``PC_PATH`` (the clouds), each cloud a scaled, shifted blob of
    ``points`` points."""
    data, pc = os.path.join(root, "ShapeNet-55"), os.path.join(root, "shapenet_pc")
    os.makedirs(data, exist_ok=True)
    os.makedirs(pc, exist_ok=True)
    rng = np.random.default_rng(seed)
    for subset, n in (("train", n_train), ("test", n_test)):
        names = []
        for i in range(n):
            name = f"{SHAPENET_TAXONOMIES[i % len(SHAPENET_TAXONOMIES)]}-{subset}{i:05d}.npy"
            cloud = rng.standard_normal((points, 3)) * rng.uniform(0.5, 2.0, 3) + rng.normal(size=3)
            np.save(os.path.join(pc, name), cloud.astype(np.float32))
            names.append(name)
        with open(os.path.join(data, f"{subset}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return {"DATA_PATH": data, "PC_PATH": pc}


def write_modelnet(root: str, n_train: int, n_test: int, points: int, seed: int) -> str:
    """ModelNet40's layout under ``root`` with the reader's FPS cache:
    ``SyntheticClouds`` in 10 classes (train seed ``seed``, test ``seed + 1``)."""
    os.makedirs(root, exist_ok=True)
    categories = [f"class{c:02d}" for c in range(40)]
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(categories) + "\n")
    for split, n, s in (("train", n_train, seed), ("test", n_test, seed + 1)):
        ds = SyntheticClouds(n, points, num_classes=10, seed=s, labelled=True)
        items = [ds[i][2] for i in range(n)]
        ids = [f"{categories[label]}_{i:04d}" for i, (_, label) in enumerate(items)]
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
        cache = (np.stack([p for p, _ in items]), np.asarray([lab for _, lab in items], np.int64))
        with open(os.path.join(root, f"modelnet40_{split}_8192pts_fps.dat"), "wb") as f:
            pickle.dump(cache, f)
    return root


def write_shapenetpart(root: str, n_train: int, n_test: int, points: int, seed: int) -> str:
    """ShapeNetPart's layout under ``root``: items of four categories, each
    point's part one of its category's, by the sign of its coordinates."""
    rng = np.random.default_rng(seed)
    names = sorted(SEG_CLASSES)[:4]
    synsets = {name: f"0{i + 1:07d}" for i, name in enumerate(names)}
    with open(os.path.join(_mkdir(root), "synsetoffset2category.txt"), "w") as f:
        f.write("".join(f"{name}\t{synsets[name]}\n" for name in names))
    split_dir = _mkdir(os.path.join(root, "train_test_split"))
    for subset, n in (("train", n_train), ("test", n_test)):
        items = []
        for i in range(n):
            name = names[i % len(names)]
            parts = SEG_CLASSES[name]
            xyz = rng.standard_normal((points, 3)).astype(np.float32)
            normals = xyz / np.linalg.norm(xyz, axis=1, keepdims=True)
            part = np.asarray(parts)[(xyz[:, 0] > 0).astype(int) % len(parts)]
            token = f"{subset}{i:05d}"
            np.savetxt(os.path.join(_mkdir(os.path.join(root, synsets[name])), token + ".txt"),
                       np.concatenate([xyz, normals, part[:, None]], axis=1), fmt="%.6f")
            items.append(f"shape_data/{synsets[name]}/{token}")
        with open(os.path.join(split_dir, f"shuffled_{subset}_file_list.json"), "w") as f:
            json.dump(items, f)
    return root


def _mkdir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def pretrain_config(path: str, base: str, shapenet: Dict, modelnet: str) -> str:
    """``base`` (a pretrain YAML) with its ShapeNet-55 and ModelNet paths
    pointed at the written sets."""
    with open(base) as f:
        cfg = yaml.safe_load(f)
    for split in ("train", "val"):
        cfg["dataset"][split]["_base_"].update(shapenet)
    for split in ("extra_train_svm", "extra_test_svm"):
        cfg["dataset"][split]["_base_"]["DATA_PATH"] = modelnet
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def seg_config(path: str, base: str, shapenetpart: str) -> str:
    """``base`` (a seg YAML) with its ShapeNetPart path pointed at the written set."""
    with open(base) as f:
        cfg = yaml.safe_load(f)
    for split in ("train", "val"):
        cfg["dataset"][split]["_base_"]["DATA_PATH"] = shapenetpart
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train", type=int, default=64, help="ShapeNet-55 train clouds")
    p.add_argument("--points", type=int, default=2048, help="points a ShapeNet-55 cloud")
    args = p.parse_args(argv)
    shapenet = write_shapenet55(os.path.join(args.out, "shapenet"), args.train, 8, args.points,
                                args.seed)
    modelnet = write_modelnet(os.path.join(args.out, "modelnet"), 64, 64, 1024, args.seed)
    part = write_shapenetpart(os.path.join(args.out, "shapenetpart"), 16, 8, 2048, args.seed)
    print(pretrain_config(os.path.join(args.out, "pretrain.yaml"), "configs/pointmae/config.yaml",
                          shapenet, modelnet))
    print(seg_config(os.path.join(args.out, "seg.yaml"), "configs/pointmae/seg_shapenetpart.yaml",
                     part))


if __name__ == "__main__":
    main()
