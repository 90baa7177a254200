"""Shared dataset-tool helpers (reference: dataset_tools/utils.py).

The port's copy of `long_video_gan_tpu/data/tools/common.py`: the same
input writes the same bytes. Host-side code only: Lanczos
center-crop-resize, buffered ZIP appends that are safe across processes, and
a thread-pool progress runner (the reference uses joblib and FileLock; the
files on disk are the same).
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor, as_completed
from io import BytesIO
from pathlib import Path
from zipfile import ZIP_STORED, ZipFile

from PIL import Image


def time_str_to_sec(time_str: str) -> float:
    """"H:MM:SS" / "MM:SS" / "SS" -> seconds."""
    parts = [float(p) for p in reversed(str(time_str).split(":"))]
    return sum(p * m for p, m in zip(parts, (1, 60, 3600)))


def center_crop_and_resize(frame: Image.Image, height: int, width: int) -> Image.Image:
    """Crop the longer-scaled dimension to the target aspect, then Lanczos
    resize (reference: dataset_tools/utils.py:38-58)."""
    height_scale = frame.height / height
    width_scale = frame.width / width
    if height_scale > width_scale:
        crop_height = height * width_scale
        y0 = (frame.height - crop_height) // 2
        frame = frame.crop((0, y0, frame.width, y0 + crop_height))
    elif width_scale > height_scale:
        crop_width = width * height_scale
        x0 = (frame.width - crop_width) // 2
        frame = frame.crop((x0, 0, x0 + crop_width, frame.height))
    return frame.resize((width, height), Image.LANCZOS)


def resize_long_edge(frame: Image.Image, long_edge: int) -> Image.Image:
    scale = long_edge / max(frame.size)
    return frame.resize((round(frame.width * scale), round(frame.height * scale)),
                        Image.LANCZOS)


class _InterProcessLock:
    """flock-based lock guarding shared ZIP appends (replaces FileLock dep)."""

    def __init__(self, path: str):
        self.path = f"{path}.lock"
        self._fd = None

    def __enter__(self):
        import fcntl

        self._fd = open(self.path, "a+")
        fcntl.flock(self._fd.fileno(), fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        import fcntl

        fcntl.flock(self._fd.fileno(), fcntl.LOCK_UN)
        self._fd.close()
        self._fd = None


class FrameWriteBuffer:
    """Buffered JPEG appends to a shared ZIP shard, safe across processes
    (reference: dataset_tools/utils.py:75-103)."""

    def __init__(self, zipfile_path, buffer_size: int = 100, quality: int = 95,
                 subsampling: int = 2):
        self.zipfile_path = Path(zipfile_path)
        self.buffer_size = buffer_size
        self.quality = quality
        self.subsampling = subsampling
        self._lock = _InterProcessLock(str(zipfile_path))
        self._paths: list[str] = []
        self._blobs: list[bytes] = []

    def add(self, frame_path: str, frame: Image.Image) -> None:
        buf = BytesIO()
        frame.save(buf, format="jpeg", quality=self.quality, subsampling=self.subsampling)
        self._paths.append(frame_path)
        self._blobs.append(buf.getvalue())
        if len(self._paths) >= self.buffer_size:
            self.flush()

    def flush(self) -> None:
        if not self._paths:
            return
        with self._lock, ZipFile(self.zipfile_path, "a", ZIP_STORED) as zf:
            for path, blob in zip(self._paths, self._blobs):
                zf.writestr(path, blob)
        self._paths.clear()
        self._blobs.clear()


def write_frame_index(zipfile_path, frame_paths: dict[str, list[str]]) -> None:
    """Append the frame_paths.json index that dataset readers require."""
    with _InterProcessLock(str(zipfile_path)), ZipFile(zipfile_path, "a", ZIP_STORED) as zf:
        zf.writestr("frame_paths.json", json.dumps(frame_paths))


def run_parallel(fn, args_list, num_workers: int = 8, desc: str = ""):
    """Thread-pool map with progress printing (replaces joblib ParallelProgressBar)."""
    results = [None] * len(args_list)
    done = 0
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = {pool.submit(fn, *args): i for i, args in enumerate(args_list)}
        for fut in as_completed(futures):
            results[futures[fut]] = fut.result()
            done += 1
            if desc:
                print(f"\r{desc}: {done}/{len(args_list)}", end="", flush=True)
    if desc:
        print()
    return results
