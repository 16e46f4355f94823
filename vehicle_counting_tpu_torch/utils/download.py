"""Pretrained-weight download: the port's copy of the JAX package's
`utils/download.py` (reference: utilities/utils.py:189-213).

Same model zoo: ultralytics YOLOv5 v6.0 release checkpoints, cached under
./.cache, relative to the working directory (networks/yolo.py:14-17).
A cached file is returned with no network; otherwise one fetch is tried,
and a failure degrades to None with a warning, so the caller falls back to
random init. Two departures from the JAX copy: the fetch has a bounded
socket timeout (JAX's `urlretrieve` has none, and a resolver that never
answers would hold the pipeline's construction), and the transfer goes to
a temporary file beside the target that is moved in only when it is
whole, so a failed transfer never leaves a partial .pt for the next run
to load.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import time
from typing import Optional

WEIGHT_URLS = {
    "yolov5n": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5n.pt",
    "yolov5s": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5s.pt",
    "yolov5m": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5m.pt",
    "yolov5l": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5l.pt",
    "yolov5x": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5x.pt",
}
# the same release's P6 checkpoints (four Detect scales), which the JAX
# package does not run
P6_WEIGHT_URLS = {
    "yolov5n6": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5n6.pt",
    "yolov5s6": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5s6.pt",
    "yolov5m6": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5m6.pt",
    "yolov5l6": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5l6.pt",
    "yolov5x6": "https://github.com/ultralytics/yolov5/releases/download/v6.0/yolov5x6.pt",
}
FETCH_TIMEOUT_S = 30.0  # per socket operation: the connect, then each read


def _fetch(url: str, dest: str) -> None:
    """Copy `url` to `dest`: into a temporary file in dest's directory,
    moved onto `dest` only once the whole body has arrived."""
    import urllib.request

    fd, part = tempfile.mkstemp(prefix=os.path.basename(dest) + ".", suffix=".part",
                                dir=os.path.dirname(dest) or ".")
    try:
        with os.fdopen(fd, "wb") as f, urllib.request.urlopen(url, timeout=FETCH_TIMEOUT_S) as body:  # noqa: S310
            shutil.copyfileobj(body, f)
        os.replace(part, dest)
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(part)


def download_pretrained_weights(name: str, cached: Optional[str] = None) -> Optional[str]:
    """Fetch `name` into ./.cache (or `cached`); returns the local path.

    Returns None (with a warning that says how long the attempt took) when
    the environment has no egress.
    """
    urls = {**WEIGHT_URLS, **P6_WEIGHT_URLS}
    if name not in urls:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(urls)}")
    cached = cached or os.path.join(".cache", f"{name}.pt")
    if os.path.exists(cached):
        return cached
    os.makedirs(os.path.dirname(cached) or ".", exist_ok=True)
    url = urls[name]
    t0 = time.perf_counter()
    try:
        _fetch(url, cached)
        return cached
    except Exception as e:  # any failure degrades to random init, as in the JAX package
        print(f"[download] could not fetch {url} ({time.perf_counter() - t0:.3f} s): {e}")
        return None


def get_model_weights(name: str, weight_path: Optional[str] = None) -> Optional[str]:
    """Reference get_model resolution order (networks/yolo.py:11-34):
    explicit --weight path wins; otherwise the cached, else downloaded,
    COCO checkpoint."""
    if weight_path:
        return weight_path
    return download_pretrained_weights(name)
