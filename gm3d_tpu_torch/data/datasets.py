"""Dataset readers, synthetic clouds and the host-side batcher.

Own copy of ``gm3d_tpu/data/datasets.py`` (numpy and Python only): the same
arrays, bit for bit, for the same arguments. Host side does IO, normalisation
and subsampling only; grouping and augmentation run on the device inside the
train step. Every dataset registers in ``DATASETS`` under its reference NAME
and, when the on-disk data is absent, raises ``FileNotFoundError`` at
construction; callers that just need a pipeline (tests, smoke runs) use
``SyntheticClouds``.

Not ported yet: ``ModelNetFewShot`` (few-shot finetune, ``ROADMAP.md``
Queue 1 item 4b) and ``ShapeNetPart`` (segmentation, item 5).

One departure: ``ModelNet`` reads its point count from ``others.npoints``
and, where the config does not set it (``configs/pointmae/
finetune_modelnet.yaml`` does not), from ``_base_.N_POINTS``, as the
reference's reader does; the JAX package's raises ``KeyError`` there.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from gm3d_tpu_torch.config.registry import DATASETS
from gm3d_tpu_torch.data import io


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Unit-sphere normalisation (``datasets/ShapeNet55Dataset.py:44-50``).

    Degenerate clouds (all points identical — e.g. a 1-row item subsampled
    with replacement) have scale 0; dividing would flood the batch with NaN
    that surfaces steps later as a NaN loss. Centered-but-unscaled matches
    the native loader (``loader.cpp pc_normalize``)."""
    centroid = pc.mean(axis=0)
    pc = pc - centroid
    scale = np.sqrt((pc**2).sum(axis=1)).max()
    return pc / scale if scale > 0 else pc


def numpy_fps(points: np.ndarray, n: int, rng: np.random.RandomState | None = None) -> np.ndarray:
    """CPU FPS used for one-time ModelNet preprocessing
    (``datasets/ModelNetDataset.py:25-46``).

    The reference seeds FPS from a RANDOM point (``:37``
    ``np.random.randint(0, N)``), unlike the CUDA kernel (index 0). Pass
    ``rng`` to reproduce that distribution deterministically per item;
    without it the seed is index 0 (the on-device convention)."""
    num = points.shape[0]
    out = np.zeros(n, dtype=np.int64)
    dist = np.full(num, np.inf)
    last = int(rng.randint(0, num)) if rng is not None else 0
    out[0] = last
    for i in range(1, n):
        d = ((points[:, :3] - points[last, :3]) ** 2).sum(axis=1)
        dist = np.minimum(dist, d)
        last = int(dist.argmax())
        out[i] = last
    return points[out]


class _ItemRng:
    """Thread-safe, restart-deterministic per-item RNG for __getitem__-time
    randomness (subsampling, point shuffles).

    A SHARED ``np.random.Generator`` is not thread-safe under the DataLoader's
    worker threads, and per-item serve counters are not restart-deterministic
    (a resumed run would redraw epoch-0 subsamples). Seeding by
    ``(tag, epoch, idx)`` is both: the epoch arrives through the DataLoader's
    ``set_epoch`` protocol, so the stream is a pure function of position —
    identical for any worker count and across crash-resume."""

    def __init__(self, tag: int):
        self._tag = int(tag)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def for_item(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self._tag, self._epoch, int(idx)])
        )



def _shuffled(rng: np.random.Generator, pts: np.ndarray) -> np.ndarray:
    """The rows of ``pts`` in the order ``rng.shuffle(pts)`` leaves them, as one
    gather: ``permutation`` draws the same swaps, while ``shuffle`` on a 2-d
    array swaps rows one by one (15 ms for 8,192 points against 0.4)."""
    return pts[rng.permutation(len(pts))]


@DATASETS.register_module("ShapeNet")
class ShapeNet55:
    """ShapeNet-55 pretrain set (``datasets/ShapeNet55Dataset.py:9-70``):
    file list ``{subset}.txt`` of ``{taxonomy}-{model}.npy``; random
    ``npoints`` subset; unit-sphere normalised; returns bare points."""

    def __init__(self, cfg):
        base = cfg["_base_"]
        others = cfg["others"]
        self.data_root = base["DATA_PATH"]
        self.pc_path = base["PC_PATH"]
        self.subset = others["subset"]
        self.npoints = others["npoints"]
        self.whole = others.get("whole", False)
        list_file = os.path.join(self.data_root, f"{self.subset}.txt")
        with open(list_file) as f:
            lines = f.read().splitlines()
        if self.whole and self.subset == "train":
            with open(os.path.join(self.data_root, "test.txt")) as f:
                lines += f.read().splitlines()
        self.file_list = []
        for line in lines:
            if not line:
                continue
            taxonomy_id = line.split("-")[0]
            model_id = line.split("-", 1)[1].split(".")[0]
            self.file_list.append((taxonomy_id, model_id, line))
        self._rng = _ItemRng(0x5A55)

    def set_epoch(self, epoch: int) -> None:
        self._rng.set_epoch(epoch)

    def __len__(self):
        return len(self.file_list)

    def __getitem__(self, idx):
        taxonomy_id, model_id, fname = self.file_list[idx]
        data = io.read_npy(os.path.join(self.pc_path, fname)).astype(np.float32)
        choice = self._rng.for_item(idx).permutation(data.shape[0])[: self.npoints]
        data = pc_normalize(data[choice])
        return taxonomy_id, model_id, data


@DATASETS.register_module("ModelNet")
class ModelNet:
    """ModelNet40 (``datasets/ModelNetDataset.py:48-145``): txt point files,
    one-time CPU-FPS to 8192 points cached as a .dat pickle."""

    def __init__(self, cfg):
        base = cfg["_base_"]
        others = cfg["others"]
        self.root = base["DATA_PATH"]
        self.npoints = others.get("npoints", base.get("N_POINTS"))
        self.use_normals = base.get("USE_NORMALS", False)
        self.num_category = base.get("NUM_CATEGORY", 40)
        self.subset = others["subset"]
        split = "train" if self.subset == "train" else "test"

        catfile = os.path.join(self.root, f"modelnet{self.num_category}_shape_names.txt")
        with open(catfile) as f:
            self.categories = f.read().splitlines()
        self.classes = {c: i for i, c in enumerate(self.categories)}
        with open(os.path.join(self.root, f"modelnet{self.num_category}_{split}.txt")) as f:
            shape_ids = f.read().splitlines()
        shape_names = ["_".join(s.split("_")[0:-1]) for s in shape_ids]
        self.datapath = [
            (shape_names[i], os.path.join(self.root, shape_names[i], shape_ids[i] + ".txt"))
            for i in range(len(shape_ids))
        ]

        cache = os.path.join(
            self.root, f"modelnet{self.num_category}_{split}_8192pts_fps.dat"
        )
        # atomic write + corrupt-cache recovery, mirroring ShapeNetPart's
        # _load_raw: an interrupted first-run FPS preprocessing must not
        # brick the dataset behind a truncated pickle forever
        loaded = False
        if os.path.exists(cache):
            try:
                with open(cache, "rb") as f:
                    self.points, self.labels = pickle.load(f)
                loaded = True
            except (EOFError, pickle.UnpicklingError, ValueError, OSError):
                pass  # re-preprocess and rewrite below
        if not loaded:
            pts_list, lbl_list = [], []
            # random FPS seed point per item, as the reference's preprocessing
            # does (``datasets/ModelNetDataset.py:37``) — deterministic here
            # via a per-item RandomState so the cache is reproducible.
            for item_i, (name, path) in enumerate(self.datapath):
                raw = io.read_txt_points(path)
                pts_list.append(numpy_fps(raw, 8192, rng=np.random.RandomState(item_i)))
                lbl_list.append(self.classes[name])
            self.points = np.stack(pts_list)
            self.labels = np.asarray(lbl_list, np.int64)
            try:
                tmp = f"{cache}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    pickle.dump((self.points, self.labels), f)
                os.replace(tmp, cache)
            except OSError:
                pass  # read-only dataset dir: run uncached
        self._rng = _ItemRng(0x30DE)

    def set_epoch(self, epoch: int) -> None:
        self._rng.set_epoch(epoch)

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, idx):
        pts = self.points[idx][: self.npoints].copy()
        pts[:, :3] = pc_normalize(pts[:, :3])
        if not self.use_normals:
            pts = pts[:, :3]
        if self.subset == "train":
            pts = _shuffled(self._rng.for_item(idx), pts)
        return "ModelNet", "sample", (pts.astype(np.float32), int(self.labels[idx]))


class _ScanObjectNNBase:
    variant_file = {
        "default": "{split}_objectdataset.h5",
        "hardest": "{split}_objectdataset_augmentedrot_scale75.h5",
    }

    def __init__(self, cfg, variant: str):
        base = cfg["_base_"]
        subset = cfg["others"]["subset"]
        split = "training" if subset == "train" else "test"
        fname = self.variant_file[variant].format(split=split)
        path = os.path.join(base["ROOT"], fname)
        data, label = io.read_h5(path)
        self.points = data.astype(np.float32)
        self.labels = label.astype(np.int64)
        self.subset = subset
        self._rng = _ItemRng(0x5CA0)

    def set_epoch(self, epoch: int) -> None:
        self._rng.set_epoch(epoch)

    def __len__(self):
        return self.points.shape[0]

    def __getitem__(self, idx):
        pts = self.points[idx]
        pts = _shuffled(self._rng.for_item(idx), pts) if self.subset == "train" else pts.copy()
        return "ScanObjectNN", "sample", (pts, int(self.labels[idx]))


@DATASETS.register_module("ScanObjectNN")
class ScanObjectNN(_ScanObjectNNBase):
    """OBJ-BG / OBJ-ONLY splits (``datasets/ScanObjectNNDataset.py:11-48``)."""

    def __init__(self, cfg):
        super().__init__(cfg, "default")


@DATASETS.register_module("ScanObjectNN_hardest")
class ScanObjectNNHardest(_ScanObjectNNBase):
    """PB-T50-RS split (``datasets/ScanObjectNNDataset.py:50-87``)."""

    def __init__(self, cfg):
        super().__init__(cfg, "hardest")


class SyntheticClouds:
    """Deterministic synthetic point clouds for tests / smoke runs: blends
    of gaussian blobs so FPS/KNN produce non-degenerate structure."""

    def __init__(self, num_samples=256, npoints=1024, num_classes=10, seed=0, labelled=False):
        self.num_samples = num_samples
        self.npoints = npoints
        self.num_classes = num_classes
        self.labelled = labelled
        self.seed = seed
        # class geometry is fixed across instances so that train/test splits
        # (different seeds) share the same underlying classes
        self._blobs = np.random.default_rng(1234).standard_normal(
            (num_classes, 8, 3)
        ).astype(np.float32)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        label = idx % self.num_classes
        rng = np.random.default_rng((self.seed + 1) * 100003 + idx)
        centers = self._blobs[label]
        which = rng.integers(0, centers.shape[0], self.npoints)
        pts = centers[which] + 0.15 * rng.standard_normal((self.npoints, 3)).astype(np.float32)
        pts = pc_normalize(pts.astype(np.float32))
        if self.labelled:
            return "Synthetic", "sample", (pts, label)
        return "Synthetic", "sample", pts


class DataLoader:
    """Host-side batcher: deterministic shuffle, drop-last, stacked numpy
    batches, optional worker threads, checkpointable iterator state.

    The same batcher as the JAX package's, so that both see the same batches
    in the same order (``torch.utils.data.DataLoader`` orders and seeds
    differently); ``data/prefetch.py`` moves its batches to the device.

    Determinism: the epoch-``e`` order is a pure function of ``(seed, e)``, so
    the stream is identical for any ``num_workers`` and reproducible across
    restarts. Checkpointing: ``state()`` returns ``{"epoch", "batch"}``;
    ``load_state()`` resumes mid-epoch at the exact next batch (the worker
    pool only changes WHO materialises items, never their order — per-batch
    futures are consumed in submission order).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_workers: int = 0, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self._next_batch = 0  # resume offset within self.epoch
        self._resume_pending = False

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    # -- checkpointable iterator state ------------------------------------
    def state(self) -> dict:
        """Position of the NEXT batch to be yielded (resume token)."""
        return {"epoch": self.epoch, "batch": self._next_batch}

    def load_state(self, state: dict) -> None:
        self.epoch = int(state.get("epoch", 0))
        self._next_batch = int(state.get("batch", 0))
        # honor the mid-epoch offset only for the NEXT iteration: every other
        # __iter__ must deliver the full epoch (a peeked-and-abandoned
        # iterator, e.g. `next(iter(loader))` for an example batch, must not
        # make later iterations skip batches)
        self._resume_pending = True

    # ----------------------------------------------------------------------
    def _epoch_batches(self, epoch: int):
        """Deterministic list of per-batch index arrays for ``epoch``."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        stop = n - (self.batch_size - 1 if self.drop_last else 0)
        return [order[s : s + self.batch_size] for s in range(0, stop, self.batch_size)]

    def _materialize(self, idx):
        items = [self.dataset[int(i)] for i in idx]
        payloads = [it[2] for it in items]
        if isinstance(payloads[0], tuple):
            cols = list(zip(*payloads))
            return tuple(
                np.stack(c) if isinstance(c[0], np.ndarray) else np.asarray(c) for c in cols
            )
        return np.stack(payloads)

    def __iter__(self):
        start = self._next_batch if self._resume_pending else 0
        self._resume_pending = False
        self._next_batch = start
        # announce the epoch for per-item RNG (see _ItemRng): keeps
        # __getitem__-time randomness a pure function of (epoch, idx)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        batches = self._epoch_batches(self.epoch)[start:]
        if self.num_workers <= 0:
            for idx in batches:
                self._next_batch += 1
                yield self._materialize(idx)
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                pending = []
                it = iter(batches)
                for idx in it:
                    pending.append(pool.submit(self._materialize, idx))
                    if len(pending) >= self.prefetch:
                        break
                while pending:
                    out = pending.pop(0).result()
                    nxt = next(it, None)
                    if nxt is not None:
                        pending.append(pool.submit(self._materialize, nxt))
                    self._next_batch += 1
                    yield out
        self.epoch += 1
        self._next_batch = 0


def build_dataset_from_cfg(cfg):
    """``datasets/build.py:7-15`` equivalent."""
    return DATASETS.get(cfg["_base_"]["NAME"])(cfg)
