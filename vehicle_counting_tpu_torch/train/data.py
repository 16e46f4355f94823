"""ImageFolder-style dataset loading for ReID training.

The port's own copy of `vehicle_counting_tpu/train/data.py` (numpy and cv2
only, host-side). Reference train.py:34-53 uses torchvision ImageFolder
over {data_dir}/train and {data_dir}/test (class-per-subdirectory,
Market1501-style). Same layout here: images are loaded with cv2, resized to
the training crop, ImageNet-normalized, optionally augmented on device
(train/augment.py), and yielded as shuffled numpy batches. The last
partial batch is dropped (train-mode BatchNorm needs more than one row).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import cv2
import numpy as np

from vehicle_counting_tpu_torch.models.reid import IMAGENET_MEAN, IMAGENET_STD

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


class ImageFolderDataset:
    """class-per-subdir image dataset, fully materialized (ReID sets are small)."""

    def __init__(self, root: str, crop_hw: Tuple[int, int] = (50, 50)):
        self.root = root
        self.crop_hw = crop_hw
        self.classes: List[str] = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        if not self.classes:
            raise ValueError(f"no class subdirectories under {root}")
        self.samples: List[Tuple[str, int]] = []
        for ci, cname in enumerate(self.classes):
            cdir = os.path.join(root, cname)
            for f in sorted(os.listdir(cdir)):
                if f.lower().endswith(IMG_EXTS):
                    self.samples.append((os.path.join(cdir, f), ci))
        if not self.samples:
            raise ValueError(f"no images under {root}")
        self._images = None
        self._labels = None

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def _materialize(self):
        if self._images is not None:
            return
        h, w = self.crop_hw
        mean = np.array(IMAGENET_MEAN, np.float32)
        std = np.array(IMAGENET_STD, np.float32)
        imgs = np.empty((len(self.samples), h, w, 3), np.float32)
        labels = np.empty((len(self.samples),), np.int32)
        for i, (path, ci) in enumerate(self.samples):
            im = cv2.imread(path)
            if im is None:
                im = np.zeros((h, w, 3), np.uint8)
            im = cv2.cvtColor(im, cv2.COLOR_BGR2RGB)
            im = cv2.resize(im, (w, h)).astype(np.float32) / 255.0
            imgs[i] = (im - mean) / std
            labels[i] = ci
        self._images, self._labels = imgs, labels

    def batches(self, batch_size: int, seed: int = 0, shuffle: bool = True) -> Iterator:
        self._materialize()
        idx = np.arange(len(self.samples))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            sel = idx[i : i + batch_size]
            yield self._images[sel], self._labels[sel]

    def all(self):
        self._materialize()
        return self._images, self._labels
