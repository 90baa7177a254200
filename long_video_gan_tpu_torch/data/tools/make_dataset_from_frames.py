"""Build a ZIP-shard frame dataset from directories of image frames.

The port's copy of `long_video_gan_tpu/data/tools/make_dataset_from_frames.py`
(reference: dataset_tools/make_dataset_from_frames.py), with an argparse CLI:
scans clip directories of images, center-crop-resizes them (Lanczos) and
writes JPEG q95 shards with their frame_paths.json index.

    python -m long_video_gan_tpu_torch.data.tools.make_dataset_from_frames \\
        --input frames/ --output datasets/mine --height 36 --width 64
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from PIL import Image

from .common import FrameWriteBuffer, center_crop_and_resize, run_parallel, write_frame_index

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scan_clip_dirs(input_dir: str, cache: bool = True) -> dict[str, list[str]]:
    """Map clip dir (relative) -> sorted frame file names; cached to
    frame_paths.json beside the input (reference :53-98)."""
    root = Path(input_dir)
    cache_path = root / "frame_paths.json"
    if cache and cache_path.is_file():
        return json.loads(cache_path.read_text())
    clips: dict[str, list[str]] = {}
    for p in sorted(root.rglob("*")):
        if p.suffix.lower() in IMAGE_EXTENSIONS:
            clips.setdefault(str(p.parent.relative_to(root)), []).append(p.name)
    clips = {k: sorted(v) for k, v in clips.items()}
    if cache:
        cache_path.write_text(json.dumps(clips))
    return clips


def save_frame_clip(zip_path: Path, input_root: Path, clip: str, names: list[str],
                    height: int, width: int) -> tuple[str, list[str]]:
    writer = FrameWriteBuffer(zip_path, quality=95)
    out_names = []
    for index, name in enumerate(names):
        with Image.open(input_root / clip / name) as image:
            frame = center_crop_and_resize(image.convert("RGB"), height, width)
        out_name = f"frame_{index:06d}.jpg"
        out_names.append(out_name)
        writer.add(f"{clip}/{out_name}", frame)
    writer.flush()
    return clip, out_names


def main(argv: Optional[list[str]] = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", dest="input_dir", required=True)
    ap.add_argument("--output", dest="output_dir", required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--partition", type=int, default=0)
    ap.add_argument("--num-partitions", type=int, default=1)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    res_dir = Path(args.output_dir) / f"{args.height:04d}x{args.width:04d}"
    res_dir.mkdir(parents=True, exist_ok=True)
    zip_path = res_dir / f"partition_{args.partition:04d}.zip"

    clips = sorted(scan_clip_dirs(args.input_dir).items())
    clips = clips[args.partition::args.num_partitions]
    print(f"Partition {args.partition}/{args.num_partitions}: {len(clips)} clips -> {zip_path}")

    results = run_parallel(
        lambda clip, names: save_frame_clip(zip_path, Path(args.input_dir), clip, names,
                                            args.height, args.width),
        clips, num_workers=args.workers, desc="Encoding clips")
    write_frame_index(zip_path, dict(results))
    print(f"Wrote {zip_path}")
    return zip_path


if __name__ == "__main__":
    main()
