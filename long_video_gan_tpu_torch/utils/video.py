"""Video/image grid writing + run-dir helpers.

The port's own copy of `long_video_gan_tpu/utils/video.py` (numpy, with
OpenCV and PIL imported only where a file is written): the port imports
nothing of the JAX package.

Encodes with OpenCV (mp4v); falls back to a PNG frame sequence if cv2 is
unavailable, and to one uint8 `.npy` array of the frames ([T, H, W, 3], RGB)
if PIL is unavailable too. Values in [-1, 1] map to uint8 like the reference
(x * 127.5 + 128, clamped).
"""

from __future__ import annotations

import math
import os
import re
from pathlib import Path
from typing import Iterable, Optional, Union

import numpy as np


def get_next_run_dir(outdir: str, desc: Optional[str] = None) -> str:
    prev = []
    if os.path.isdir(outdir):
        prev = [x for x in os.listdir(outdir) if os.path.isdir(os.path.join(outdir, x))]
    ids = [int(m.group()) for m in (re.match(r"^\d+", x) for x in prev) if m]
    run_id = max(ids, default=-1) + 1
    name = f"{run_id:05d}" if desc is None else f"{run_id:05d}-{desc}"
    run_dir = os.path.join(outdir, name)
    assert not os.path.exists(run_dir)
    return run_dir


def to_uint8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x) * 127.5 + 128, 0, 255).astype(np.uint8)


def _multiple_nearest_sqrt(number: int) -> int:
    for i in range(int(math.sqrt(number)), 0, -1):
        if number % i == 0:
            return i
    return 1


def make_grid(frames: np.ndarray, num_rows: Optional[int] = None) -> np.ndarray:
    """[N, C, H, W] -> [H*rows, W*cols, C] grid (reference layout: utils.py:171)."""
    n, c, h, w = frames.shape
    num_rows = num_rows or _multiple_nearest_sqrt(n)
    num_cols = n // num_rows
    grid = frames.reshape(num_cols, num_rows, c, h, w)       # (nw nh) c h w
    grid = grid.transpose(1, 3, 0, 4, 2)                     # nh h nw w c
    return grid.reshape(num_rows * h, num_cols * w, c)


def _pad_to_multiple_of_16(frame: np.ndarray) -> np.ndarray:
    h, w = frame.shape[:2]
    ph, pw = (-h) % 16, (-w) % 16
    if ph or pw:
        frame = np.pad(frame, [(0, ph), (0, pw), (0, 0)], mode="edge")
    return frame


def write_video_grid(
    segments: Union[np.ndarray, Iterable[np.ndarray]],
    path: os.PathLike,
    fps: int = 30,
    max_samples: Optional[int] = None,
    num_rows: Optional[int] = None,
    convert_to_uint8: bool = True,
) -> None:
    """Write [N, C, T, H, W] video (or an iterator of segments) as an mp4 grid."""
    if isinstance(segments, np.ndarray) or hasattr(segments, "shape"):
        segments = [segments]

    writer = None
    try:
        for segment in segments:
            segment = np.asarray(segment)
            segment = to_uint8(segment) if convert_to_uint8 else segment.astype(np.uint8)
            if max_samples:
                segment = segment[:max_samples]
            num_rows = num_rows or _multiple_nearest_sqrt(segment.shape[0])
            for t in range(segment.shape[2]):
                frame = make_grid(segment[:, :, t], num_rows)
                frame = _pad_to_multiple_of_16(frame)
                writer = _append_frame(writer, path, frame, fps)
    finally:
        if writer is not None and hasattr(writer, "release"):
            writer.release()


def _append_frame(writer, path, frame_rgb: np.ndarray, fps: int):
    try:
        import cv2

        if writer is None:
            h, w = frame_rgb.shape[:2]
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            writer = cv2.VideoWriter(str(path), fourcc, fps, (w, h))
            assert writer.isOpened(), f"cv2.VideoWriter failed to open {path}"
        writer.write(frame_rgb[:, :, ::-1])                  # RGB -> BGR
        return writer
    except ImportError:
        pass
    try:
        # PNG sequence fallback: <path>.frames/NNNNNN.png
        from PIL import Image

        frames_dir = Path(str(path) + ".frames")
        frames_dir.mkdir(parents=True, exist_ok=True)
        if writer is None:
            writer = [0]
        Image.fromarray(frame_rgb).save(frames_dir / f"{writer[0]:06d}.png")
        writer[0] += 1
        return writer
    except ImportError:
        writer = writer or _NpyWriter(Path(str(path) + ".npy"))
        writer.frames.append(frame_rgb)
        return writer


class _NpyWriter:
    """Without cv2 and PIL: the frames as one uint8 [T, H, W, 3] array."""

    def __init__(self, path: Path):
        self.path, self.frames = path, []

    def release(self) -> None:
        np.save(self.path, np.stack(self.frames))


def save_image_grid(image: np.ndarray, path: os.PathLike,
                    max_samples: Optional[int] = None, num_rows: Optional[int] = None,
                    convert_to_uint8: bool = True) -> None:
    """Write [N, C, H, W] images as one PNG grid."""
    from PIL import Image

    image = to_uint8(image) if convert_to_uint8 else np.asarray(image).astype(np.uint8)
    if max_samples:
        image = image[:max_samples]
    Image.fromarray(make_grid(image, num_rows)).save(path)
