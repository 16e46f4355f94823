"""Host-side video decode/encode — the only host compute in the pipeline.

Mirrors the observable contract of the reference's VideoSet/VideoLoader/
VideoWriter (modules/datasets.py): cv2 decode, BGR->RGB, frame ids starting
at 1 (datasets.py:51-54), skip-unreadable-frame semantics (datasets.py:49-52,
63-76), `video_info` dict {name, width, height, fps, num_frames}
(datasets.py:29-43), mp4v writer at source fps/size (datasets.py:117-121),
and a rewindable stream for the visualization second pass (datasets.py:99-100).

Difference from the reference: frames are yielded in fixed-size BATCHES (the detector
is frame-parallel; SURVEY.md §5 long-context note), zero-padded at the tail
with a validity mask, ready for one upload per batch.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Tuple

import cv2
import numpy as np

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".m4v")


def list_videos(path: str) -> List[str]:
    """A file -> [file]; a directory -> sorted video files inside."""
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.lower().endswith(VIDEO_EXTS)
        )
    return [path]


class VideoReader:
    """Batched frame source over one video file."""

    def __init__(self, video_path: str, batch_size: int = 8):
        self.video_path = video_path
        self.batch_size = batch_size
        self.stream = cv2.VideoCapture(video_path)
        if not self.stream.isOpened():
            raise IOError(f"cannot open video: {video_path}")
        self.video_info: Dict = {
            "name": os.path.basename(video_path),
            "width": int(self.stream.get(cv2.CAP_PROP_FRAME_WIDTH)),
            "height": int(self.stream.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            "fps": self.stream.get(cv2.CAP_PROP_FPS),
            "num_frames": int(self.stream.get(cv2.CAP_PROP_FRAME_COUNT)),
        }
        self._next_frame_id = 1  # frame ids are 1-based (datasets.py:51-54)

    def reinitialize_stream(self) -> None:
        """Rewind for the visualization second pass (datasets.py:99-100)."""
        self.stream.release()
        self.stream = cv2.VideoCapture(self.video_path)
        self._next_frame_id = 1

    def frames(self) -> Iterator[Tuple[int, np.ndarray]]:
        """Yield (frame_id, RGB frame); silently skip unreadable frames."""
        while True:
            ok, frame = self.stream.read()
            if not ok or frame is None:
                if self._next_frame_id <= self.video_info["num_frames"]:
                    # unreadable mid-stream frame: keep id sequence moving
                    self._next_frame_id += 1
                    if self.stream.get(cv2.CAP_PROP_POS_FRAMES) >= self.video_info["num_frames"]:
                        return
                    continue
                return
            fid = self._next_frame_id
            self._next_frame_id += 1
            yield fid, cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (frames [B,H,W,3] u8, frame_ids [B] i64, valid [B] bool)."""
        b = self.batch_size
        h, w = self.video_info["height"], self.video_info["width"]
        buf = np.zeros((b, h, w, 3), np.uint8)
        ids = np.zeros((b,), np.int64)
        n = 0
        for fid, frame in self.frames():
            if frame.shape[:2] != (h, w):
                frame = cv2.resize(frame, (w, h))
            buf[n] = frame
            ids[n] = fid
            n += 1
            if n == b:
                yield buf.copy(), ids.copy(), np.ones(b, bool)
                n = 0
        if n:
            valid = np.zeros(b, bool)
            valid[:n] = True
            buf[n:] = 0
            ids[n:] = 0
            yield buf.copy(), ids.copy(), valid

    def release(self) -> None:
        self.stream.release()


class VideoWriter:
    """mp4 writer at source fps/size (datasets.py:102-121 contract)."""

    def __init__(self, video_info: Dict, output_path: str, codec: str = "mp4v"):
        self.video_info = video_info
        self.output_path = output_path
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        self.writer = cv2.VideoWriter(
            output_path,
            cv2.VideoWriter_fourcc(*codec),
            video_info["fps"] or 30.0,
            (video_info["width"], video_info["height"]),
        )

    def write_rgb(self, frame_rgb: np.ndarray) -> None:
        self.writer.write(cv2.cvtColor(frame_rgb, cv2.COLOR_RGB2BGR))

    def write_bgr(self, frame_bgr: np.ndarray) -> None:
        self.writer.write(frame_bgr)

    def release(self) -> None:
        self.writer.release()
