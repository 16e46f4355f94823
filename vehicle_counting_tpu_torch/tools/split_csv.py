#!/usr/bin/env python
"""Stratified train/val split of a labels CSV.

The port's own copy of `vehicle_counting_tpu/tools/split_csv.py` (host only).

Role-equivalent of the reference utilities/tools/split_csv.py:20-61: groups
rows by image, stratifies on each image's dominant class, writes a `fold`
column (0 = train, 1 = val).
"""

from __future__ import annotations

import argparse

import numpy as np
import pandas as pd


def split_csv(df: pd.DataFrame, ratio: float = 0.9, image_col: str = "image_id",
              label_col: str = "class_id", seed: int = 1702) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    dominant = df.groupby(image_col)[label_col].agg(lambda s: s.value_counts().idxmax())
    val_images = set()
    for cls, imgs in dominant.groupby(dominant):
        ids = list(imgs.index)
        rng.shuffle(ids)
        n_val = max(1, int(len(ids) * (1 - ratio))) if len(ids) > 1 else 0
        val_images.update(ids[:n_val])
    out = df.copy()
    out["fold"] = out[image_col].map(lambda i: 1 if i in val_images else 0)
    return out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--csv", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--ratio", type=float, default=0.9)
    p.add_argument("--image_col", default="image_id")
    p.add_argument("--label_col", default="class_id")
    args = p.parse_args()
    df = pd.read_csv(args.csv)
    out = split_csv(df, args.ratio, args.image_col, args.label_col)
    out.to_csv(args.output, index=False)
    print(f"train rows: {(out.fold == 0).sum()}, val rows: {(out.fold == 1).sum()}")


if __name__ == "__main__":
    main()
