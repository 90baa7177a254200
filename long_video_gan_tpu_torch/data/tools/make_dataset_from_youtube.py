"""Build a dataset from YouTube videos listed in a clip-interval config.

The port's copy of `long_video_gan_tpu/data/tools/make_dataset_from_youtube.py`
(reference: dataset_tools/make_dataset_from_youtube.py), with an argparse
CLI: a JSON config maps video ids to lists of [start, end] intervals (the
released horseback.json has 44 videos, biking.json 28); each interval
becomes one clip directory of JPEG frames in the ZIP shard.

Downloading needs yt-dlp, which this tool does not ship: without it, pass
--video-dir, a directory of videos already downloaded and named
<video_id>.<ext>, and the decode, crop and shard stage runs offline.

    python -m long_video_gan_tpu_torch.data.tools.make_dataset_from_youtube \\
        --config horseback.json --video-dir raw/ --output datasets/horseback \\
        --height 144 --width 256

Config format (as the reference's youtube_configs/*.json):
    {"<video_id>": [["0:10", "0:55"], ["1:20", "2:03"]], ...}
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from .common import FrameWriteBuffer, center_crop_and_resize, time_str_to_sec, write_frame_index
from .make_dataset_from_videos import iter_video_frames


def download_video(video_id: str, out_dir: Path) -> Path:
    if shutil.which("yt-dlp") is None:
        raise RuntimeError(
            "yt-dlp is not installed in this environment; download videos "
            "elsewhere and pass --video-dir with files named <video_id>.<ext>")
    out = out_dir / f"{video_id}.mp4"
    if out.is_file():
        return out
    cmd = ["yt-dlp", "-f", "bestvideo[ext=mp4]/best", "-o", str(out),
           f"https://www.youtube.com/watch?v={video_id}"]
    subprocess.run(cmd, check=True)
    return out


def find_video_file(video_dir: Path, video_id: str) -> Optional[Path]:
    for p in video_dir.glob(f"{video_id}.*"):
        return p
    return None


def main(argv: Optional[list[str]] = None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", dest="config_path", required=True,
                    help="JSON: {video_id: [[start, end], ...]}")
    ap.add_argument("--output", dest="output_dir", required=True)
    ap.add_argument("--video-dir", default=None,
                    help="Directory of pre-downloaded videos (skips yt-dlp)")
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--partition", type=int, default=0)
    ap.add_argument("--num-partitions", type=int, default=1)
    args = ap.parse_args(argv)
    config = json.loads(Path(args.config_path).read_text())
    res_dir = Path(args.output_dir) / f"{args.height:04d}x{args.width:04d}"
    res_dir.mkdir(parents=True, exist_ok=True)
    zip_path = res_dir / f"partition_{args.partition:04d}.zip"

    video_ids = sorted(config.keys())[args.partition::args.num_partitions]
    index = {}
    for video_id in video_ids:
        if args.video_dir:
            path = find_video_file(Path(args.video_dir), video_id)
            if path is None:
                print(f"Missing video file for {video_id}, skipping")
                continue
        else:
            path = download_video(video_id, res_dir.parent / "raw")

        for clip_idx, (start, end) in enumerate(config[video_id]):
            t0, t1 = time_str_to_sec(start), time_str_to_sec(end)
            clip = f"{video_id}/clip_{clip_idx:04d}"
            writer = FrameWriteBuffer(zip_path, quality=100, subsampling=0)
            names = []
            for i, frame in enumerate(iter_video_frames(path, trim_start=t0, end_time=t1)):
                frame = center_crop_and_resize(frame, args.height, args.width)
                name = f"frame_{i:06d}.jpg"
                names.append(name)
                writer.add(f"{clip}/{name}", frame)
            writer.flush()
            if names:
                index[clip] = names
            print(f"{clip}: {len(names)} frames")

    write_frame_index(zip_path, index)
    print(f"Wrote {zip_path}")
    return zip_path


if __name__ == "__main__":
    main()
