"""ROI filtering, direction assignment, and the counting CSV artifact.

Reproduces the reference's observable contract:
  - labelme zone JSON: zone polygon = first shape's points; direction vectors
    are shapes whose label starts with "direction", keyed by the label's LAST
    TWO characters (utilities/counting/utils.py:128-137);
  - per-track direction = argmax cosine similarity of (first-center ->
    last-center) vs each annotated direction's (first -> second point), with
    best initialized to the first direction key and a strictly-positive score
    required to displace it (utilities/counting/utils.py:139-152);
  - CSV schema: one row per (track, frame) with columns
    track_id, frame_id, box, color, label, direction, fpoint, lpoint,
    fframe, lframe (utilities/counting/utils.py:154-198; README.md:79-94);
  - only track points whose bbox intersects the zone polygon are counted
    (modules/track.py:104);
  - a vehicle is "counted" on the frame where its track ends
    (lframe == frame_id; utilities/counting/utils.py:285-287).

The per-point polygon filter and the per-track direction argmax are fully
vectorized (one matrix op over all rows) instead of the reference's
per-element Python loops.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from vehicle_counting_tpu_torch.counting.polygon import (
    boxes_intersect_polygon,
    cosine_similarity_batch,
)
from vehicle_counting_tpu_torch.utils.colors import color_for_track

CSV_COLUMNS = [
    "track_id",
    "frame_id",
    "box",
    "color",
    "label",
    "direction",
    "fpoint",
    "lpoint",
    "fframe",
    "lframe",
]


def load_zone_anno(zone_path: str) -> Tuple[list, Dict[str, list]]:
    """Load a labelme annotation: (zone polygon points, {dir_key: points}).

    Direction keys are the last two characters of the shape label, matching
    the reference (counting/utils.py:136 `i['label'][-2:]`).
    """
    with open(zone_path, "r") as f:
        anno = json.load(f)
    shapes = anno["shapes"]
    zone = shapes[0]["points"]
    directions = {
        s["label"][-2:]: s["points"]
        for s in shapes
        if s["label"].startswith("direction")
    }
    return zone, directions


def find_best_match_direction(obj_vector, paths: Dict[str, list]) -> str:
    """Best-cosine direction key for one track vector.

    obj_vector: ((x0, y0), (x1, y1)) first/last track centers.
    paths: {key: [[x, y], [x, y], ...]} direction polylines (first 2 pts used).
    Contract: counting/utils.py:139-152 — init best to the first key, require
    score > current best (strictly) with best_score starting at 0.
    """
    keys = list(paths.keys())
    vec = np.asarray(
        [[obj_vector[1][0] - obj_vector[0][0], obj_vector[1][1] - obj_vector[0][1]]]
    )
    dir_vecs = np.asarray(
        [[paths[k][1][0] - paths[k][0][0], paths[k][1][1] - paths[k][0][1]] for k in keys]
    )
    sims = cosine_similarity_batch(vec, dir_vecs)[0]
    best, best_score = keys[0], 0.0
    for k, s in zip(keys, sims):
        if s > best_score:
            best, best_score = k, float(s)
    return best


def assign_directions(vectors: np.ndarray, paths: Dict[str, list]) -> List[str]:
    """Vectorized direction assignment for [N, 2] track displacement vectors."""
    keys = list(paths.keys())
    dir_vecs = np.asarray(
        [[paths[k][1][0] - paths[k][0][0], paths[k][1][1] - paths[k][0][1]] for k in keys]
    )
    sims = cosine_similarity_batch(np.atleast_2d(vectors), dir_vecs)  # [N, D]
    # Reference rule: first key wins unless a strictly positive higher score
    # appears; scanning keys in order with `>` reproduces its tie behavior.
    out: List[str] = []
    for row in sims:
        best, best_score = keys[0], 0.0
        for k, s in zip(keys, row):
            if s > best_score:
                best, best_score = k, float(s)
        out.append(best)
    return out


def save_tracking_to_csv(track_dict: Sequence[Dict], filename: str) -> pd.DataFrame:
    """Write the counting CSV with the reference's exact schema.

    track_dict: list over classes of {track_id: {"boxes": [...], "frames":
    [...], "color": (b,g,r), "direction": key}} — the same structure the
    reference builds (modules/track.py:104-133), one row per (track, frame).
    """
    rows = {c: [] for c in CSV_COLUMNS}
    for label_id, tracks in enumerate(track_dict):
        for track_id, rec in tracks.items():
            boxes = rec["boxes"]
            frames = rec["frames"]
            if len(boxes) == 0:
                continue
            b0, b1 = np.asarray(boxes[0]), np.asarray(boxes[-1])
            fpoint = (float(b0[2] + b0[0]) / 2, float(b0[3] + b0[1]) / 2)
            lpoint = (float(b1[2] + b1[0]) / 2, float(b1[3] + b1[1]) / 2)
            for frame_id, box in zip(frames, boxes):
                rows["track_id"].append(track_id)
                rows["frame_id"].append(frame_id)
                rows["box"].append(np.asarray(box).tolist())
                rows["color"].append(rec["color"])
                rows["label"].append(label_id)
                rows["direction"].append(rec["direction"])
                rows["fpoint"].append(fpoint)
                rows["lpoint"].append(lpoint)
                rows["fframe"].append(frames[0])
                rows["lframe"].append(frames[-1])
    df = pd.DataFrame(rows)
    if filename is not None:
        df.to_csv(filename, index=False)
    return df


class VehicleCounter:
    """Zone-filtered track accumulation + direction assignment + CSV.

    Role-equivalent of the reference `VideoCounting` (modules/track.py:72-138)
    but consuming flat arrays and doing the polygon filter in one vectorized
    call over every (frame, track) row.
    """

    def __init__(self, class_names: Sequence[str], zone_path: str, minimum_length: int = 4):
        self.class_names = list(class_names)
        self.num_classes = len(self.class_names)
        self.minimum_length = minimum_length  # kept for surface parity (unused upstream too)
        self.zone_path = zone_path
        self.polygons, self.directions = load_zone_anno(zone_path)
        self.track_dict: List[Dict] = [{} for _ in range(self.num_classes)]

    def run(
        self,
        frames: Sequence[int],
        tracks: Sequence[int],
        labels: Sequence[int],
        boxes,
        output_path: Optional[str] = None,
    ) -> List[Dict]:
        """frames/tracks/labels: [N] aligned rows; boxes: [N, 4] xyxy."""
        frames = np.asarray(frames, dtype=np.int64)
        tracks = np.asarray(tracks, dtype=np.int64)
        labels = np.asarray(labels, dtype=np.int64)
        boxes = np.asarray(boxes)
        if boxes.size == 0:
            boxes = boxes.reshape(0, 4)

        keep = (
            boxes_intersect_polygon(self.polygons, boxes)
            if len(boxes)
            else np.zeros(0, dtype=bool)
        )
        for frame_id, track_id, label_id, box in zip(
            frames[keep], tracks[keep], labels[keep], boxes[keep]
        ):
            per_class = self.track_dict[int(label_id)]
            rec = per_class.get(int(track_id))
            if rec is None:
                rec = per_class[int(track_id)] = {
                    "boxes": [],
                    "frames": [],
                    "color": color_for_track(track_id, label_id),
                }
            rec["boxes"].append(np.asarray(box))
            rec["frames"].append(int(frame_id))

        # Vectorized direction assignment over all surviving tracks.
        flat: List[Tuple[int, int]] = []
        vecs: List[np.ndarray] = []
        for label_id in range(self.num_classes):
            for track_id, rec in self.track_dict[label_id].items():
                b0, b1 = rec["boxes"][0], rec["boxes"][-1]
                c0 = np.array([(b0[2] + b0[0]) / 2, (b0[3] + b0[1]) / 2])
                c1 = np.array([(b1[2] + b1[0]) / 2, (b1[3] + b1[1]) / 2])
                flat.append((label_id, track_id))
                vecs.append(c1 - c0)
        if flat:
            dirs = assign_directions(np.stack(vecs), self.directions)
            for (label_id, track_id), d in zip(flat, dirs):
                self.track_dict[label_id][track_id]["direction"] = d

        if output_path is not None:
            save_tracking_to_csv(self.track_dict, output_path)
        return self.track_dict


def count_directions(df: pd.DataFrame, num_classes: int) -> Dict[str, np.ndarray]:
    """Final per-direction, per-class vehicle counts from a counting CSV.

    A vehicle is attributed to its direction once, on its last frame
    (lframe == frame_id rule; counting/utils.py:276-297).
    """
    ends = df[df["lframe"] == df["frame_id"]]
    out: Dict[str, np.ndarray] = {}
    for direction, group in ends.groupby("direction"):
        counts = np.zeros(num_classes, dtype=np.int64)
        for label, n in group.groupby("label").size().items():
            counts[int(label)] = n
        # CSV round-trips numeric keys like "01" to ints; normalize back to the
        # 2-char direction-key convention (label[-2:], counting/utils.py:136).
        key = str(direction)
        if key.isdigit():
            key = key.zfill(2)
        out[key] = counts
    return out
