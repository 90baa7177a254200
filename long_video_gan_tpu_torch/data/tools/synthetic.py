"""Synthetic dataset builder: writes a tiny ZIP-shard dataset in the exact
on-disk format (for tests, smoke runs and benchmarks without real data).

The port's copy of `long_video_gan_tpu/data/tools/synthetic.py`: the same
seed writes the same frames and shards.
"""

from __future__ import annotations

import json
from pathlib import Path
from zipfile import ZIP_STORED, ZipFile

import numpy as np

from ..jpeg import encode_jpeg


def make_synthetic_dataset(root: str, resolutions: list[tuple[int, int]],
                           num_videos: int = 3, frames_per_video: int = 40,
                           num_partitions: int = 2, seed: int = 0) -> None:
    """Create `<root>/<HHHH>x<WWWW>/partition_*.zip` shards of moving-gradient
    JPEG frames with the frame_paths.json index, identical clip lists across
    resolutions (required by VideoDatasetTwoRes)."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0, 2 * np.pi, size=(num_videos, 3))

    for height, width in resolutions:
        res_dir = Path(root) / f"{height:04d}x{width:04d}"
        res_dir.mkdir(parents=True, exist_ok=True)
        for part in range(num_partitions):
            index = {}
            zip_path = res_dir / f"partition_{part:04d}.zip"
            with ZipFile(zip_path, "w", ZIP_STORED) as zf:
                for v in range(part, num_videos, num_partitions):
                    clip = f"video_{v:04d}"
                    names = []
                    for t in range(frames_per_video):
                        yy, xx = np.mgrid[0:height, 0:width]
                        frame = np.stack([
                            np.sin(xx / width * 6 + t * 0.3 + phases[v, c]) * 0.5 + 0.5
                            + 0.3 * np.cos(yy / height * 4 + t * 0.1)
                            for c in range(3)
                        ], axis=-1)
                        frame = np.clip(frame, 0, 1)
                        blob = encode_jpeg((frame * 255).astype(np.uint8), quality=95)
                        name = f"frame_{t:06d}.jpg"
                        zf.writestr(f"{clip}/{name}", blob)
                        names.append(name)
                    index[clip] = names
                zf.writestr("frame_paths.json", json.dumps(index))
