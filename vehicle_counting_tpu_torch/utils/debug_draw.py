"""Matplotlib debug drawers: detection / pred-vs-GT box plots.

Counterparts of the reference's `draw_boxes_v2` and `draw_pred_gt_boxes`
(the reference utilities/utils.py:52-137) — developer-facing matplotlib
figures for eyeballing detections and evaluation pairs. (In the reference
these are dead code on the main path — only `write_to_video` is imported by
the pipeline — so nothing downstream consumes the output; the contract is
the figure layout: tlwh rectangles, `label: score` text above each box at a
per-label color, axis off, tight bounding box; the pred/GT variant renders
two side-by-side panels titled 'Prediction' / 'Ground Truth' and skips GT
rows with label < 0.)

The port's own copy of `vehicle_counting_tpu/utils/debug_draw.py`.
Differences by design: images are numpy arrays or tensors, HWC RGB (CHW
tolerated), the per-label color comes from the deterministic palette in
utils.colors (the reference indexed a webcolors name table; colors are
display-only), and both functions are pure file writers (Agg backend, no
GUI). They need matplotlib, which a card's host may lack: there they raise
ImportError (the counting path never calls them).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _label_color(label: int):
    from vehicle_counting_tpu_torch.utils.colors import color_for_track

    b, g, r = color_for_track(0, int(label))
    return (r / 255.0, g / 255.0, b / 255.0)


def _to_hwc(img) -> np.ndarray:
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img)
    if img.ndim == 4:
        img = img.squeeze(0)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)  # CHW input tolerated
    return img


def _draw_panel(ax, boxes, labels, scores, obj_list, fontsize=15):
    import matplotlib.patches as patches

    for i, (box, label) in enumerate(zip(boxes, labels)):
        label = int(label)
        if label < 0:
            continue
        x, y, w, h = (float(v) for v in box)
        color = _label_color(label)
        ax.add_patch(
            patches.Rectangle(
                (x, y), w, h, linewidth=1.5, edgecolor=color, facecolor="none"
            )
        )
        name = obj_list[label] if obj_list is not None else label
        if scores is not None:
            text = f"{name}: {np.round(float(scores[i]), 3)}"
        else:
            text = f"{name}"
        ax.text(x, y - 3, text, color=color, fontsize=fontsize)


def draw_detections(
    out_path: str,
    img,
    boxes,                       # [N, 4] tlwh
    labels,                      # [N] int
    scores,                      # [N]
    obj_list: Optional[Sequence[str]] = None,
    figsize=(15, 15),
) -> None:
    """One image + detection boxes -> out_path (reference draw_boxes_v2)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=figsize)
    ax.imshow(_to_hwc(img))
    _draw_panel(ax, boxes, labels, scores, obj_list)
    ax.axis("off")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


def draw_pred_gt(
    out_path: str,
    img,
    pred_boxes,                  # [N, 4] tlwh
    pred_labels,
    pred_scores,
    gt_boxes,                    # [M, 4] tlwh; label < 0 rows skipped
    gt_labels,
    obj_list: Optional[Sequence[str]] = None,
    figsize=(10, 10),
) -> None:
    """Side-by-side prediction / ground-truth panels (draw_pred_gt_boxes)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(nrows=1, ncols=2, figsize=figsize)
    hwc = _to_hwc(img)
    ax1.imshow(hwc)
    ax2.imshow(hwc)
    ax1.set_title("Prediction")
    ax2.set_title("Ground Truth")
    _draw_panel(ax1, pred_boxes, pred_labels, pred_scores, obj_list)
    _draw_panel(ax2, gt_boxes, gt_labels, None, obj_list)
    ax1.axis("off")
    ax2.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
