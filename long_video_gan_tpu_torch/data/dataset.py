"""ZIP-shard video datasets.

The port's own copy of `long_video_gan_tpu/data/dataset.py` (what training
and the metrics read), with the same on-disk contract:
`<root>/<HHHH>x<WWWW>/partition_*.zip` shards of JPEG frames, each shard
carrying a `frame_paths.json` index mapping clip path -> ordered frame names.
Readers return float32 CHW frames in [-1, 1].

Host-side only (numpy); decoding uses the native batched JPEG decoder, built
at first use, with a PIL fallback.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path, PurePosixPath
from typing import Any, Optional
from zipfile import ZipFile

import numpy as np

from .jpeg import decode_jpeg_batch


@dataclass
class VideoDataset:
    """Random fixed-length clips with random frame spacing."""

    dataset_dir: str
    seq_length: int
    height: int
    width: int
    min_spacing: int = 1
    max_spacing: int = 1
    min_video_length: Optional[int] = None
    x_flip: bool = False

    def __post_init__(self):
        assert self.seq_length >= 1
        self.dataset_path = Path(self.dataset_dir) / f"{self.height:04d}x{self.width:04d}"
        assert self.dataset_path.is_dir(), f"missing dataset dir: {self.dataset_path}"

        self.frame_paths: dict[str, dict] = {}
        for partition in sorted(self.dataset_path.glob("*.zip")):
            with ZipFile(partition) as zf:
                with zf.open("frame_paths.json", "r") as fp:
                    self.frame_paths[partition.stem] = json.load(fp)

        self.min_video_length = max(self.min_video_length or 1,
                                    (self.seq_length - 1) * self.min_spacing + 1)
        self.video_paths = [
            (partition_name, clip_path, frame_names)
            for partition_name, part in sorted(self.frame_paths.items())
            for clip_path, frame_names in sorted(part.items())
            if len(frame_names) >= self.min_video_length
        ]
        self._zipfiles: dict[str, ZipFile] = {}

    # -- raw IO --------------------------------------------------------------

    def _zip(self, partition_name: str) -> ZipFile:
        zf = self._zipfiles.get(partition_name)
        if zf is None:
            zf = ZipFile(self.dataset_path / f"{partition_name}.zip")
            self._zipfiles[partition_name] = zf
        return zf

    def read_frame_bytes(self, partition_name: str, frame_path: str) -> bytes:
        with self._zip(partition_name).open(frame_path, "r") as fp:
            return fp.read()

    def _frames_to_video(self, blobs: list[bytes]) -> np.ndarray:
        frames = decode_jpeg_batch(blobs)                       # [T, H, W, C] uint8
        video = frames.transpose(3, 0, 1, 2).astype(np.float32)  # C T H W
        return 2.0 * video / 255.0 - 1.0

    # -- sampling ------------------------------------------------------------

    def sample_frame_names(self, frame_names: list[str], rng: np.random.Generator):
        if self.seq_length == 1:
            max_spacing = 1
        else:
            max_spacing = min(self.max_spacing, (len(frame_names) - 1) // (self.seq_length - 1))
        spacing = int(rng.integers(self.min_spacing, max_spacing + 1))
        frame_span = (self.seq_length - 1) * spacing + 1
        start = int(rng.integers(0, len(frame_names) - frame_span + 1))
        return frame_names[start:start + frame_span:spacing], spacing

    def __getitem__(self, index: int) -> dict[str, Any]:
        return self.sample(index, np.random.default_rng())

    def sample(self, index: int, rng: np.random.Generator) -> dict[str, Any]:
        partition_name, clip_path, frame_names = self.video_paths[index]
        frame_names, spacing = self.sample_frame_names(frame_names, rng)
        blobs = [self.read_frame_bytes(partition_name, str(PurePosixPath(clip_path) / f))
                 for f in frame_names]
        video = self._frames_to_video(blobs)
        if self.x_flip and rng.random() < 0.5:
            video = video[..., ::-1].copy()
        return dict(video=video, spacing=spacing)

    def __len__(self) -> int:
        return len(self.video_paths)

    def __getstate__(self):
        return dict(self.__dict__, _zipfiles={})


@dataclass
class VideoDatasetTwoRes:
    """Paired lr+hr clips with identical frame indices and flip."""

    dataset_dir: str
    seq_length: int
    lr_height: int
    lr_width: int
    hr_height: int
    hr_width: int
    min_spacing: int = 1
    max_spacing: int = 1
    min_video_length: Optional[int] = None
    x_flip: bool = False

    def __post_init__(self):
        common = dict(dataset_dir=self.dataset_dir, seq_length=self.seq_length,
                      min_spacing=self.min_spacing, max_spacing=self.max_spacing,
                      min_video_length=self.min_video_length, x_flip=self.x_flip)
        self.lr_dataset = VideoDataset(height=self.lr_height, width=self.lr_width, **common)
        self.hr_dataset = VideoDataset(height=self.hr_height, width=self.hr_width, **common)
        assert self.lr_dataset.video_paths == self.hr_dataset.video_paths, \
            "lr/hr resolutions must index identical clips"

    def sample(self, index: int, rng: np.random.Generator) -> dict[str, Any]:
        partition_name, clip_path, frame_names = self.lr_dataset.video_paths[index]
        frame_names, spacing = self.lr_dataset.sample_frame_names(frame_names, rng)
        paths = [str(PurePosixPath(clip_path) / f) for f in frame_names]
        lr = self.lr_dataset._frames_to_video(
            [self.lr_dataset.read_frame_bytes(partition_name, p) for p in paths])
        hr = self.hr_dataset._frames_to_video(
            [self.hr_dataset.read_frame_bytes(partition_name, p) for p in paths])
        if self.x_flip and rng.random() < 0.5:
            lr = lr[..., ::-1].copy()
            hr = hr[..., ::-1].copy()
        return dict(lr_video=lr, hr_video=hr, spacing=spacing)

    def __getitem__(self, index: int) -> dict[str, Any]:
        return self.sample(index, np.random.default_rng())

    def __len__(self) -> int:
        return len(self.lr_dataset)


@dataclass
class VideoDatasetPerImage:
    """Every frame (or frame window) is one item, tagged with the number of
    samples its source video contributes so FID can weight each video equally
    (dataset.py:166-197; consumed by metrics/metric_utils.py)."""

    dataset_dir: str
    height: int
    width: int
    seq_length: int = 1
    x_flip: bool = False

    def __post_init__(self):
        self.dataset = VideoDataset(self.dataset_dir, seq_length=1,
                                    height=self.height, width=self.width)
        self.video_paths = []
        for partition_name, part in sorted(self.dataset.frame_paths.items()):
            for clip_path, frame_names in sorted(part.items()):
                num_samples = len(frame_names) - self.seq_length + 1
                for start in range(num_samples):
                    window = frame_names[start:start + self.seq_length]
                    self.video_paths.append((partition_name, clip_path, window, num_samples))

    def sample(self, index: int, rng: np.random.Generator) -> dict[str, Any]:
        partition_name, clip_path, names, num_samples = self.video_paths[index]
        paths = [str(PurePosixPath(clip_path) / f) for f in names]
        video = self.dataset._frames_to_video(
            [self.dataset.read_frame_bytes(partition_name, p) for p in paths])
        if self.x_flip and rng.random() < 0.5:
            video = video[..., ::-1].copy()
        return dict(video=video, num_samples_from_source=num_samples)

    def __getitem__(self, index: int) -> dict[str, Any]:
        return self.sample(index, np.random.default_rng())

    def __len__(self) -> int:
        return len(self.video_paths)
