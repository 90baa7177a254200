"""Build a ZIP-shard frame dataset from video files.

The port's copy of `long_video_gan_tpu/data/tools/make_dataset_from_videos.py`
(reference: dataset_tools/make_dataset_from_videos.py), with an argparse CLI:
decode (OpenCV; the reference used PyAV) -> trim -> center-crop-resize
(Lanczos) -> JPEG q100 without chroma subsampling -> ZIP shard, the shard
chosen by --partition/--num-partitions for parallel machines.

    python -m long_video_gan_tpu_torch.data.tools.make_dataset_from_videos \\
        --input videos/ --output datasets/mine --height 144 --width 256
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

from PIL import Image

from .common import (FrameWriteBuffer, center_crop_and_resize, resize_long_edge, run_parallel,
                     write_frame_index)

VIDEO_EXTENSIONS = (".avi", ".mkv", ".mov", ".mp4", ".wmv", ".webm")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("decoding videos needs OpenCV (the cv2 module), which is not "
                           "installed; extract the frames with another tool and use "
                           "make_dataset_from_frames instead") from e
    return cv2


def iter_video_frames(video_path: str, trim_start: float = 0.0, trim_end: float = 0.0,
                      end_time: Optional[float] = None):
    """Decode frames as PIL RGB images with cv2 (timestamps in seconds).
    `trim_end` trims from the video's end; `end_time` is an absolute cutoff."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        print(f"Failed to open video file: {video_path}")
        return
    try:
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        total = cap.get(cv2.CAP_PROP_FRAME_COUNT)
        duration = total / fps if total > 0 else float("inf")
        end_time = min(duration - trim_end, end_time if end_time is not None else float("inf"))
        if trim_start > 0:
            cap.set(cv2.CAP_PROP_POS_MSEC, trim_start * 1000.0)
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            t = cap.get(cv2.CAP_PROP_POS_MSEC) / 1000.0
            if t > end_time:
                break
            yield Image.fromarray(frame[:, :, ::-1])  # BGR -> RGB
    finally:
        cap.release()


def save_video_clip(zipfile_path: Path, video_path: Path, relative_dir: Path,
                    height, width, long_edge, trim_start: float = 0.0,
                    trim_end: float = 0.0) -> tuple[str, list[str]]:
    """Decode one video into JPEG frames appended to the shard; returns
    (clip_path, frame_names) for the index (reference :27-88)."""
    writer = FrameWriteBuffer(zipfile_path, quality=100, subsampling=0)
    frame_names = []
    for index, frame in enumerate(iter_video_frames(video_path, trim_start, trim_end)):
        if height is not None and width is not None:
            frame = center_crop_and_resize(frame, height, width)
        elif long_edge is not None:
            frame = resize_long_edge(frame, long_edge)
        name = f"frame_{index:06d}.jpg"
        frame_names.append(name)
        writer.add(str(relative_dir / name), frame)
    writer.flush()
    return str(relative_dir), frame_names


def list_video_paths(input_dir: str) -> list[tuple[Path, Path]]:
    root = Path(input_dir)
    if not root.is_dir():
        raise ValueError(f"Directory not found: {input_dir}")
    out = []
    for p in sorted(root.rglob("*")):
        if p.suffix.lower() in VIDEO_EXTENSIONS:
            out.append((p, p.relative_to(root).with_suffix("")))
    return out


def main(argv: Optional[list[str]] = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", dest="input_dir", required=True)
    ap.add_argument("--output", dest="output_dir", required=True)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--long-edge", type=int, default=None)
    ap.add_argument("--trim-start", type=float, default=0.0)
    ap.add_argument("--trim-end", type=float, default=0.0)
    ap.add_argument("--partition", type=int, default=0)
    ap.add_argument("--num-partitions", type=int, default=1,
                    help="Shard count; run one process per partition")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    if not ((args.height and args.width) or args.long_edge):
        ap.error("pass --height/--width or --long-edge")
    res_name = (f"{args.height:04d}x{args.width:04d}" if args.height
                else f"long{args.long_edge}")
    res_dir = Path(args.output_dir) / res_name
    res_dir.mkdir(parents=True, exist_ok=True)
    zip_path = res_dir / f"partition_{args.partition:04d}.zip"

    videos = list_video_paths(args.input_dir)
    videos = videos[args.partition::args.num_partitions]
    print(f"Partition {args.partition}/{args.num_partitions}: {len(videos)} videos -> "
          f"{zip_path}")

    results = run_parallel(
        lambda vp, rd: save_video_clip(zip_path, vp, rd, args.height, args.width,
                                       args.long_edge, args.trim_start, args.trim_end),
        videos, num_workers=args.workers, desc="Encoding videos")
    index = {clip: names for clip, names in results if names}
    write_frame_index(zip_path, index)
    print(f"Wrote {zip_path} with {sum(len(v) for v in index.values())} frames")
    return zip_path


if __name__ == "__main__":
    main()
