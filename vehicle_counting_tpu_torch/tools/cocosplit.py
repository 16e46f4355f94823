#!/usr/bin/env python
"""Split a COCO annotation json into train/val parts.

The port's own copy of `vehicle_counting_tpu/tools/cocosplit.py` (host only).

Role-equivalent of the reference utilities/tools/cocosplit.py:32-52.
"""

from __future__ import annotations

import argparse
import json
import random


def split_coco(coco: dict, ratio: float, seed: int = 1702):
    images = list(coco["images"])
    rng = random.Random(seed)
    rng.shuffle(images)
    n_train = int(len(images) * ratio)
    train_imgs, val_imgs = images[:n_train], images[n_train:]

    def subset(imgs):
        ids = {im["id"] for im in imgs}
        return {
            "images": imgs,
            "annotations": [a for a in coco["annotations"] if a["image_id"] in ids],
            "categories": coco["categories"],
        }

    return subset(train_imgs), subset(val_imgs)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--annotation", required=True)
    p.add_argument("--ratio", type=float, default=0.9)
    p.add_argument("--train", required=True)
    p.add_argument("--val", required=True)
    p.add_argument("--seed", type=int, default=1702)
    args = p.parse_args()
    with open(args.annotation) as f:
        coco = json.load(f)
    train, val = split_coco(coco, args.ratio, args.seed)
    json.dump(train, open(args.train, "w"))
    json.dump(val, open(args.val, "w"))
    print(f"train: {len(train['images'])} images; val: {len(val['images'])} images")


if __name__ == "__main__":
    main()
