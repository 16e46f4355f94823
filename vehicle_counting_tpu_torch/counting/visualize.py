"""Annotated-video second pass (the MP4 artifact), pixel-exact vs reference.

Reproduces the reference visualize_merged contract and RENDERING
(utilities/counting/utils.py:7-126, 250-331) so frames are pixel-equal given
the same CSV and source frames (per-track colors are seeded data in the CSV,
so they carry through):

  * track arrow = 3px line + filled r=8 endpoint circle (draw_arrow, :7-12);
  * labeled box: thickness-scaled rectangle, filled header strip, black
    'key || value' text with the reference's exact size math (:17-32);
  * zone polygon red 5px, direction arrows black + PLAIN-1.5 black labels
    (draw_anno, :103-121);
  * per-direction counts keyed int(direction), incremented on each track's
    LAST frame (lframe == frame_id, :276-287), displayed one frame late
    (:307-328) as outlined multiline text at the bottom-left (draw_text,
    :35-101);
  * green 'Frame:N' counter at (10, 25) (:123-126).
"""

from __future__ import annotations

import ast
from typing import Dict

import cv2
import numpy as np
import pandas as pd


def _parse(v):
    return ast.literal_eval(v) if isinstance(v, str) else v


def draw_arrow(img, p0, p1, color) -> np.ndarray:
    """3px line with a filled radius-8 circle at the head (utils.py:7-12)."""
    p0 = (int(p0[0]), int(p0[1]))
    p1 = (int(p1[0]), int(p1[1]))
    cv2.line(img, p0, p1, color, 3)
    cv2.circle(img, p1, 8, color, -1)
    return img


def draw_text(
    img,
    text: str,
    uv_top_left=None,
    color=(255, 255, 255),
    font_scale: float = 0.75,
    thickness: int = 1,
    outline_color=(0, 0, 0),
    line_spacing: float = 1.5,
) -> np.ndarray:
    """Outlined multiline text; default anchor bottom-left (utils.py:35-101)."""
    font = cv2.FONT_HERSHEY_SIMPLEX
    lines = text.splitlines()
    if uv_top_left is None:
        (_, h), _ = cv2.getTextSize(lines[0], font, font_scale, thickness)
        uv_top_left = (10, img.shape[0] - h * (len(lines) + 3))
    pos = np.asarray(uv_top_left, dtype=float)
    for line in lines:
        (_, h), _ = cv2.getTextSize(line, font, font_scale, thickness)
        org = tuple((pos + [0, h]).astype(int))
        if outline_color is not None:
            cv2.putText(img, line, org, font, font_scale, outline_color,
                        thickness * 3, cv2.LINE_AA)
        cv2.putText(img, line, org, font, font_scale, color, thickness, cv2.LINE_AA)
        pos += [0, h * line_spacing]
    return img


def draw_anno(img, zone, directions: Dict) -> np.ndarray:
    """Zone polygon (red, 5px) + black direction arrows/labels (utils.py:103-121)."""
    if zone is not None and len(zone):
        pts = np.asarray(zone, np.int32).reshape(-1, 1, 2)
        cv2.polylines(img, [pts], True, (0, 0, 255), 5)
    for key, path in (directions or {}).items():
        p0 = np.asarray(path[0], np.int32)
        p1 = np.asarray(path[1], np.int32)
        draw_arrow(img, p0, p1, (0, 0, 0))
        cv2.putText(img, str(key), (int(p1[0]), int(p1[1])),
                    cv2.FONT_HERSHEY_PLAIN, 1.5, (0, 0, 0), 3)
    return img


def draw_one_box(img, box, key=None, value=None, color=None, line_thickness=None) -> np.ndarray:
    """Rectangle + filled 'key || value' header, reference size math (utils.py:17-32)."""
    tl = line_thickness or int(round(0.001 * max(img.shape[0:2])))
    c1 = (int(box[0]), int(box[1]))
    c2 = (int(box[2]), int(box[3]))
    c = tuple(int(v) for v in color) if color is not None else (0, 255, 0)
    cv2.rectangle(img, c1, c2, c, thickness=tl * 2)
    if key is not None and value is not None:
        header = f"{key} || {value}"
        tf = max(tl - 2, 1)
        s_size = cv2.getTextSize(f"| {value}", 0, fontScale=float(tl) / 3, thickness=tf)[0]
        t_size = cv2.getTextSize(f"{key} |", 0, fontScale=float(tl) / 3, thickness=tf)[0]
        hdr = (c1[0] + t_size[0] + s_size[0] + 15, c1[1] - t_size[1] - 3)
        cv2.rectangle(img, c1, hdr, c, -1)
        # the reference passes FONT_HERSHEY_SIMPLEX (0) as lineType — keep it
        # for pixel parity
        cv2.putText(img, header, (c1[0], c1[1] - 2), 0, float(tl) / 3, [0, 0, 0],
                    thickness=tf, lineType=0)
    return img


def visualize_one_frame(img, frame_df: pd.DataFrame) -> np.ndarray:
    """Per-row track arrow + labeled box (utils.py:250-274)."""
    for _, row in frame_df.iterrows():
        box = _parse(row.box)
        color = tuple(int(v) for v in _parse(row.color))
        fpoint = np.asarray(_parse(row.fpoint)).astype(int)
        cpoint = np.asarray(
            [(box[2] + box[0]) / 2, (box[3] + box[1]) / 2]
        ).astype(int)
        draw_arrow(img, fpoint, cpoint, color)
        draw_one_box(img, box, key=f"id: {row.track_id}",
                     value=f"cls: {row.label}", color=color)
    return img


def count_frame_directions(frame_df: pd.DataFrame, count_dict: Dict) -> str:
    """Increment counts for tracks ENDING this frame; return the display text.

    count_dict is keyed by int(direction) and the text keeps the reference's
    trailing separators (utils.py:276-297).
    """
    for _, row in frame_df.iterrows():
        if row.lframe == row.frame_id:
            d = int(row.direction)
            if d in count_dict:
                count_dict[d][int(row.label)] += 1
    lines = []
    for d, per_class in count_dict.items():
        lines.append(
            f"direction:{d} || " + "".join(f"{c}:{n} | " for c, n in per_class.items())
        )
    return "\n".join(lines)


def visualize_merged(reader, csv_path: str, directions: Dict, zone, num_classes: int, writer) -> Dict:
    """Second pass over `reader`, drawing tracks + counts into `writer`.

    Returns the final per-direction count dict (keys int(direction), matching
    the reference's count_dict construction, utils.py:301-305).
    """
    df = pd.read_csv(csv_path)
    count_dict = {int(d): {c: 0 for c in range(num_classes)} for d in directions}
    prev_text = None

    for frames, frame_ids, valid in reader.batches():
        for i in range(len(frames)):
            if not valid[i]:
                continue
            fid = int(frame_ids[i])
            img = cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR)
            frame_df = df[df.frame_id.astype(int) == fid]
            text = count_frame_directions(frame_df, count_dict)
            img = draw_anno(img, zone, directions)
            if len(frame_df) > 0:
                img = visualize_one_frame(img, frame_df)
            if prev_text:  # reference displays counts delayed one frame
                draw_text(img, prev_text)
            prev_text = text
            draw_text(img, f"Frame:{fid}", (10, 25), color=(0, 255, 0))
            writer.write_bgr(img)
    return count_dict
