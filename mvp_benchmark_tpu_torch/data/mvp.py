"""MVP loaders (HDF5, RAM-resident) + host-side batching (port of
``mvp_benchmark_tpu/data/mvp.py``).

- ``MVPCompletionDataset`` == ``MVP_CP`` (``completion/dataset.py:8-46``):
  keys ``incomplete_pcds``, ``complete_pcds``, ``labels``; the complete cloud
  for partial index i is ``complete_pcds[i // 26]``; the extra-test split has
  no gt.
- ``MVPRegistrationDataset`` == ``MVP_RG`` (``registration/dataset.py:38-128``):
  the train split re-poses (src, tgt) on the fly with random SE(3) pairs
  (``data/augment.py``, numpy); val ships ``rotated_src/rotated_tgt/
  transforms/rot_level``; category filtering by ``cat_labels``.

The final batch is padded to full size and carries its real ``count``.
Without the dataset files both build the same deterministic synthetic
clouds as the JAX package, bit for bit. ``h5py`` is imported only when a
file is read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np

from mvp_benchmark_tpu_torch.data import augment

VIEWS_PER_MODEL = 26


def _synthetic_clouds(n: int, num_points: int, seed: int) -> np.ndarray:
    """Deterministic unit-cube point clouds for dataset-free runs."""
    rng = np.random.default_rng(seed)
    # Sample from a few blobs per cloud so FPS/kNN have structure to find.
    centers = rng.random((n, 4, 3), dtype=np.float32)
    pts = centers.repeat(num_points // 4, axis=1)
    pts = pts + 0.05 * rng.standard_normal(pts.shape).astype(np.float32)
    return np.clip(pts, 0.0, 1.0).astype(np.float32)


@dataclasses.dataclass
class BatchSpec:
    batch_size: int
    shuffle: bool = False
    seed: int = 0
    drop_last: bool = False
    num_shards: int = 1
    shard_id: int = 0


class _BatchedDataset:
    """Shared batching logic: shuffle, shard, pad the final batch."""

    def __len__(self) -> int:
        raise NotImplementedError

    def _get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def batches(self, spec: BatchSpec, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self)
        order = np.arange(n)
        if spec.shuffle:
            rng = np.random.default_rng((spec.seed, epoch))
            rng.shuffle(order)
        order = order[spec.shard_id :: spec.num_shards]
        bs = spec.batch_size
        n_sh = len(order)
        stop = (n_sh // bs) * bs if spec.drop_last else n_sh
        for start in range(0, stop, bs):
            idx = order[start : start + bs]
            count = len(idx)
            if count < bs:
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - count)])
            batch = self._get_batch(idx)
            batch["count"] = np.asarray(count, np.int32)
            yield batch

    def steps_per_epoch(self, spec: BatchSpec) -> int:
        n_sh = (len(self) + spec.num_shards - 1 - spec.shard_id) // spec.num_shards
        if spec.drop_last:
            return n_sh // spec.batch_size
        return (n_sh + spec.batch_size - 1) // spec.batch_size


class MVPCompletionDataset(_BatchedDataset):
    def __init__(
        self,
        prefix: str = "train",
        data_dir: str = "./data",
        num_points: int = 2048,
        synthetic_size: Optional[int] = None,
    ):
        if prefix not in ("train", "val", "test"):
            raise ValueError("prefix should be [train/val/test]")
        self.prefix = prefix
        fname = {
            "train": "MVP_Train_CP.h5",
            "val": "MVP_Test_CP.h5",
            "test": "MVP_ExtraTest_Shuffled_CP.h5",
        }[prefix]
        path = os.path.join(data_dir, fname)

        if os.path.exists(path):
            import h5py

            with h5py.File(path, "r") as f:
                self.input_data = np.asarray(f["incomplete_pcds"][()], np.float32)
                if prefix != "test":
                    self.gt_data = np.asarray(f["complete_pcds"][()], np.float32)
                    self.labels = np.asarray(f["labels"][()])
            self.synthetic = False
        else:
            n = synthetic_size or {"train": 260, "val": 52, "test": 52}[prefix]
            n = (n // VIEWS_PER_MODEL) * VIEWS_PER_MODEL or VIEWS_PER_MODEL
            self.input_data = _synthetic_clouds(n, num_points, seed=7)
            if prefix != "test":
                self.gt_data = _synthetic_clouds(
                    n // VIEWS_PER_MODEL, num_points, seed=8
                )
                self.labels = np.arange(n) % 16
            self.synthetic = True

    def __len__(self) -> int:
        return self.input_data.shape[0]

    def _get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        out = {"inputs": self.input_data[idx]}
        if self.prefix != "test":
            out["gt"] = self.gt_data[idx // VIEWS_PER_MODEL]
            out["label"] = np.asarray(self.labels[idx])
        return out


class MVPRegistrationDataset(_BatchedDataset):
    """Registration pairs: val/train batches carry src, tgt, transform,
    match_level and rot_level; the test split src and tgt only. Without the
    HDF5 files: 64/32/32 synthetic clouds (seed 11 for src, 12 for the train
    tgt), and val/test tgt = src under poses drawn from a generator seeded 13,
    as ``mvp_benchmark_tpu/data/mvp.py:186-206`` builds them. The train split
    augments with the numpy ``augment_pair`` drawing from ``seed``."""

    def __init__(
        self,
        prefix: str,
        max_angle: float = 180.0,
        max_trans: float = 0.5,
        category: Optional[int] = None,
        data_dir: str = "./data",
        num_points: int = 2048,
        synthetic_size: Optional[int] = None,
        seed: int = 0,
    ):
        if prefix not in ("train", "val", "test"):
            raise ValueError("prefix should be [train/val/test]")
        self.prefix = prefix
        self.max_angle = max_angle / 180.0 * np.pi
        self.max_trans = max_trans
        self.rng = np.random.default_rng(seed)
        fname = {
            "train": "MVP_Train_RG.h5",
            "val": "MVP_Test_RG.h5",
            "test": "MVP_ExtraTest_RG.h5",
        }[prefix]
        path = os.path.join(data_dir, fname)

        if os.path.exists(path):
            import h5py

            with h5py.File(path, "r") as f:
                self.label = f["cat_labels"][:].astype("int32")
                if prefix == "test":
                    self.src = np.asarray(f["rotated_src"][:], np.float32)
                    self.tgt = np.asarray(f["rotated_tgt"][:], np.float32)
                else:
                    self.match_level = np.asarray(f["match_level"][:], np.int32)
                    if prefix == "train":
                        self.src = np.asarray(f["src"][:], np.float32)
                        self.tgt = np.asarray(f["tgt"][:], np.float32)
                        self.rot_level = int(1) if max_angle > 45 else int(0)
                    else:
                        self.src = np.asarray(f["rotated_src"][:], np.float32)
                        self.tgt = np.asarray(f["rotated_tgt"][:], np.float32)
                        self.transforms = np.asarray(f["transforms"][:], np.float32)
                        self.rot_level = np.asarray(f["rot_level"][:], np.int32)
            self.synthetic = False
        else:
            n = synthetic_size or {"train": 64, "val": 32, "test": 32}[prefix]
            base = _synthetic_clouds(n, num_points, seed=11)
            self.src = base
            self.label = (np.arange(n) % 16).astype(np.int32)
            self.match_level = (np.arange(n) % 2).astype(np.int32)
            if prefix == "train":
                self.tgt = _synthetic_clouds(n, num_points, seed=12)
                self.rot_level = int(1) if max_angle > 45 else int(0)
            else:
                # a consistent split: tgt = src under a known pose
                rng = np.random.default_rng(13)
                tgts, poses = [], []
                for i in range(n):
                    T = augment.random_pose(self.max_angle / 2, max_trans / 2, rng)
                    tgts.append(base[i] @ T[:3, :3].T + T[:3, 3])
                    poses.append(T)
                self.tgt = np.asarray(tgts, np.float32)
                self.transforms = np.asarray(poses, np.float32)
                self.rot_level = (np.arange(n) % 2).astype(np.int32)
            self.synthetic = True

        if category:
            keep = self.label == category
            self.src, self.tgt = self.src[keep], self.tgt[keep]
            if prefix != "test":
                self.match_level = self.match_level[keep]
                if prefix == "val":
                    self.transforms = self.transforms[keep]
                    self.rot_level = self.rot_level[keep]
            self.label = self.label[keep]

    def __len__(self) -> int:
        return self.src.shape[0]

    def _augment_batch(self, src: np.ndarray, tgt: np.ndarray):
        """Train-time SE(3) augmentation, one ``augment_pair`` a sample."""
        srcs, tgts, trans = [], [], []
        for k in range(len(src)):
            s, t, T = augment.augment_pair(
                src[k], tgt[k], self.max_angle, self.max_trans, self.rng)
            srcs.append(s)
            tgts.append(t)
            trans.append(T)
        return {"src": np.asarray(srcs), "tgt": np.asarray(tgts),
                "transform": np.asarray(trans)}

    def _get_batch(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        src = self.src[idx]
        tgt = self.tgt[idx]
        if self.prefix == "test":
            return {"src": src, "tgt": tgt}
        if self.prefix == "train":
            out = self._augment_batch(src, tgt)
            out.update(
                match_level=self.match_level[idx],
                rot_level=np.full(len(idx), self.rot_level, np.int32),
            )
            return out
        return {
            "src": src,
            "tgt": tgt,
            "transform": self.transforms[idx],
            "match_level": self.match_level[idx],
            "rot_level": self.rot_level[idx],
        }
