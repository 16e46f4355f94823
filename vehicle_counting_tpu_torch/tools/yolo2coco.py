#!/usr/bin/env python
"""Convert YOLO-format annotations (one .txt per image) to a COCO json.

The port's own copy of `vehicle_counting_tpu/tools/yolo2coco.py` (host only).

Role-equivalent of the reference utilities/tools/yolo2coco.py:30-96:
`python -m vehicle_counting_tpu_torch.tools.yolo2coco --image_dir D --label_dir L \
    --class_names names.txt --output out.json`
YOLO lines are `class cx cy w h` normalized; COCO boxes are [x, y, w, h]
absolute pixels.
"""

from __future__ import annotations

import argparse
import json
import os


def yolo_to_coco(image_dir: str, label_dir: str, class_names, output: str | None = None) -> dict:
    import cv2

    images, annotations = [], []
    ann_id = 1
    files = sorted(
        f for f in os.listdir(image_dir) if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    for img_id, fname in enumerate(files, start=1):
        path = os.path.join(image_dir, fname)
        img = cv2.imread(path)
        if img is None:
            continue
        h, w = img.shape[:2]
        images.append({"id": img_id, "file_name": fname, "width": w, "height": h})
        label_path = os.path.join(label_dir, os.path.splitext(fname)[0] + ".txt")
        if not os.path.exists(label_path):
            continue
        with open(label_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 5:
                    continue
                cls, cx, cy, bw, bh = int(parts[0]), *map(float, parts[1:])
                x = (cx - bw / 2) * w
                y = (cy - bh / 2) * h
                annotations.append(
                    {
                        "id": ann_id,
                        "image_id": img_id,
                        "category_id": cls + 1,
                        "bbox": [x, y, bw * w, bh * h],
                        "area": bw * w * bh * h,
                        "iscrowd": 0,
                    }
                )
                ann_id += 1
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [
            {"id": i + 1, "name": n, "supercategory": "none"} for i, n in enumerate(class_names)
        ],
    }
    if output:
        with open(output, "w") as f:
            json.dump(coco, f)
    return coco


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--image_dir", required=True)
    p.add_argument("--label_dir", required=True)
    p.add_argument("--class_names", required=True, help="txt file, one class per line")
    p.add_argument("--output", required=True)
    args = p.parse_args()
    with open(args.class_names) as f:
        names = [l.strip() for l in f if l.strip()]
    coco = yolo_to_coco(args.image_dir, args.label_dir, names, args.output)
    print(f"wrote {len(coco['images'])} images / {len(coco['annotations'])} anns to {args.output}")


if __name__ == "__main__":
    main()
