"""Vectorized planar geometry for ROI-zone counting.

Reference semantics (utilities/counting/bb_polygon.py):
  - point-in-polygon by ray casting with a vertical ray towards +y
    (bb_polygon.py:68-93 uses `extreme = [x, 1e9]`), where a point lying ON a
    polygon edge counts as inside (bb_polygon.py:84-87);
  - a bbox intersects the polygon iff ANY of its 4 corners is inside
    (bb_polygon.py:96-114);
  - direction similarity = cosine of the two segment vectors
    (bb_polygon.py:117-124).

The reference tests one point at a time in pure Python; here everything is
vectorized over N points x E edges so whole track histories are filtered in
one shot.
"""

from __future__ import annotations

import numpy as np

_EDGE_TOL = 1e-9


def points_in_polygon(polygon, points) -> np.ndarray:
    """Vectorized point-in-polygon test.

    Args:
      polygon: [P, 2] array-like of vertices (open ring; closing edge implied).
      points:  [N, 2] array-like of query points.

    Returns:
      bool [N]; True if inside or on an edge (matching the reference's
      on-edge-is-inside convention).
    """
    poly = np.asarray(polygon, dtype=np.float64)
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    if poly.ndim != 2 or poly.shape[0] < 3:
        raise ValueError(f"polygon must be [P>=3, 2], got {poly.shape}")

    x1, y1 = poly[:, 0], poly[:, 1]  # edge starts [E]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)  # edge ends [E]
    px = pts[:, 0:1]  # [N,1]
    py = pts[:, 1:2]

    # --- on-edge test (cross product ~ 0 and within bounding box) ----------
    cross = (y2 - y1) * (px - x1) - (x2 - x1) * (py - y1)  # [N,E]
    # scale tolerance by edge length so large-coordinate zones behave
    edge_len = np.hypot(x2 - x1, y2 - y1)
    collinear = np.abs(cross) <= _EDGE_TOL * np.maximum(edge_len, 1.0) * np.maximum(
        np.maximum(np.abs(px), np.abs(py)), 1.0
    )
    in_box = (
        (px >= np.minimum(x1, x2) - _EDGE_TOL)
        & (px <= np.maximum(x1, x2) + _EDGE_TOL)
        & (py >= np.minimum(y1, y2) - _EDGE_TOL)
        & (py <= np.maximum(y1, y2) + _EDGE_TOL)
    )
    on_edge = np.any(collinear & in_box, axis=1)  # [N]

    # --- crossing count with a vertical upward ray --------------------------
    # Half-open interval in x avoids double counting at shared vertices.
    straddles = ((x1 <= px) & (px < x2)) | ((x2 <= px) & (px < x1))  # [N,E]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(x2 != x1, (px - x1) / np.where(x2 != x1, x2 - x1, 1.0), 0.0)
        y_at = y1 + t * (y2 - y1)
    crosses = straddles & (y_at > py)
    inside = (np.sum(crosses, axis=1) % 2) == 1

    return inside | on_edge


def is_point_in_polygon(polygon, point) -> bool:
    """Scalar convenience wrapper (reference: bb_polygon.py:68-93)."""
    return bool(points_in_polygon(polygon, np.asarray(point)[None, :])[0])


def boxes_intersect_polygon(polygon, boxes) -> np.ndarray:
    """True per box iff any of its 4 corners lies inside the polygon.

    Reference: bb_polygon.py:96-114 (`check_bbox_intersect_polygon`); boxes are
    xyxy. Note this deliberately reproduces the reference's corner-only rule —
    a box fully containing the polygon with all corners outside reads False.
    """
    b = np.atleast_2d(np.asarray(boxes, dtype=np.float64))
    n = b.shape[0]
    corners = np.stack(
        [
            b[:, [0, 1]],
            b[:, [2, 1]],
            b[:, [2, 3]],
            b[:, [0, 3]],
        ],
        axis=1,
    ).reshape(n * 4, 2)
    hit = points_in_polygon(polygon, corners).reshape(n, 4)
    return np.any(hit, axis=1)


def check_bbox_intersect_polygon(polygon, bbox) -> bool:
    """Scalar wrapper with the reference's exact name/contract."""
    return bool(boxes_intersect_polygon(polygon, np.asarray(bbox)[None, :])[0])


def cosin_similarity(a2d, b2d) -> float:
    """Cosine similarity between two 2-point segments (bb_polygon.py:117-124).

    Each argument is ((x0, y0), (x1, y1)); the vector is end - start.
    """
    a = np.asarray([a2d[1][0] - a2d[0][0], a2d[1][1] - a2d[0][1]], dtype=np.float64)
    b = np.asarray([b2d[1][0] - b2d[0][0], b2d[1][1] - b2d[0][1]], dtype=np.float64)
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(np.dot(a, b) / denom)


def cosine_similarity_batch(vectors, direction_vectors) -> np.ndarray:
    """Cosine similarity of N track vectors against D direction vectors.

    Args:
      vectors: [N, 2] displacement vectors (last center - first center).
      direction_vectors: [D, 2] annotated direction vectors.

    Returns:
      [N, D] similarity matrix (NaN-free: zero vectors give -inf so they never
      win an argmax).
    """
    v = np.asarray(vectors, dtype=np.float64)
    d = np.asarray(direction_vectors, dtype=np.float64)
    num = v @ d.T  # [N, D]
    denom = np.linalg.norm(v, axis=1, keepdims=True) * np.linalg.norm(d, axis=1)[None, :]
    out = np.full_like(num, -np.inf)
    np.divide(num, denom, out=out, where=denom > 0)
    return out
