#!/usr/bin/env python
"""Split an image folder (optionally with YOLO label txts) into train/val.

The port's own copy of `vehicle_counting_tpu/tools/split_images.py` (host only).

Role-equivalent of the reference utilities/tools/split_images.py:18-68.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil


def split_images(image_dir: str, out_dir: str, ratio: float = 0.9,
                 label_dir: str | None = None, seed: int = 1702):
    files = sorted(
        f for f in os.listdir(image_dir) if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    rng = random.Random(seed)
    rng.shuffle(files)
    n_train = int(len(files) * ratio)
    splits = {"train": files[:n_train], "val": files[n_train:]}
    for split, names in splits.items():
        img_out = os.path.join(out_dir, split, "images")
        os.makedirs(img_out, exist_ok=True)
        lbl_out = None
        if label_dir:
            lbl_out = os.path.join(out_dir, split, "labels")
            os.makedirs(lbl_out, exist_ok=True)
        for name in names:
            shutil.copy(os.path.join(image_dir, name), os.path.join(img_out, name))
            if label_dir:
                lbl = os.path.splitext(name)[0] + ".txt"
                src = os.path.join(label_dir, lbl)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(lbl_out, lbl))
    return {k: len(v) for k, v in splits.items()}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--image_dir", required=True)
    p.add_argument("--label_dir", default=None)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ratio", type=float, default=0.9)
    args = p.parse_args()
    counts = split_images(args.image_dir, args.out_dir, args.ratio, args.label_dir)
    print(counts)


if __name__ == "__main__":
    main()
