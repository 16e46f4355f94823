"""Display colors for track visualization.

The reference keeps a named-color table and samples one color at random per
track (utilities/utils.py:13-50, modules/track.py:111). Colors are purely a
display artifact — parity checks must treat them as non-deterministic
(SURVEY.md "float quirks"). Here the palette is generated, and per-track color
assignment is deterministic given (track_id, label) so reruns are stable.
"""

from __future__ import annotations

from typing import List, Tuple

BGRColor = Tuple[int, int, int]


def _build_palette() -> List[BGRColor]:
    # Evenly spaced hues at two saturation/value levels -> 84 visually distinct
    # BGR colors, no external deps.
    palette: List[BGRColor] = []
    for s, v in ((1.0, 1.0), (0.6, 1.0), (1.0, 0.7)):
        for i in range(28):
            h = i / 28.0 * 6.0
            c = v * s
            x = c * (1 - abs(h % 2 - 1))
            m = v - c
            r, g, b = (
                (c, x, 0) if h < 1 else
                (x, c, 0) if h < 2 else
                (0, c, x) if h < 3 else
                (0, x, c) if h < 4 else
                (x, 0, c) if h < 5 else
                (c, 0, x)
            )
            palette.append((int((b + m) * 255), int((g + m) * 255), int((r + m) * 255)))
    return palette


color_list: List[BGRColor] = _build_palette()


def color_for_track(track_id: int, label: int = 0) -> BGRColor:
    """Deterministic pseudo-random palette pick per (track, class)."""
    idx = (int(track_id) * 2654435761 + int(label) * 40503) % len(color_list)
    return color_list[idx]
