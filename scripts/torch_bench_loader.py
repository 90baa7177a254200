"""Host data rate of the port's training loader: batches/s of
`data.loader.InfiniteLoader` over a JPEG dataset made with the port's
dataset tool, at the batch shapes of the trainers' full presets.

  * sres: `VideoDatasetTwoRes`, 32 clips of 4 + 2 x 4 frames, 36x64 and
    144x256 (`train_sres`);
  * lres: `VideoDataset`, 64 clips of 128 frames at 36x64 (`train_lres`).

For each of `--workers` (the loader's default 4, and the trainers' 8) and
each of `--decoders` in turn (`native`: `data.jpeg.decode_jpeg_batch`, which
must have loaded the native decoder; `pil`: its PIL fallback, put in the
dataset's place), the loader is built, `WARMUP` batches are taken, and then
the time to take `--batches` more is read on the host clock: the rate at
which decoding and collation deliver batches when nothing waits on the
consumer. Prints the JPEG decoder (the native one names its libjpeg), the
host's cores, the card's name and power limit where there is one, and one
JSON line per configuration. The dataset is made in a temporary directory
from a seed; making it is not timed.

    python3 scripts/torch_bench_loader.py
    python3 scripts/torch_bench_loader.py --decoders native,pil,pil,native
    python3 scripts/torch_bench_loader.py --workers 4 --batches 4 --videos 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from long_video_gan_tpu_torch.data import dataset as dataset_module  # noqa: E402
from long_video_gan_tpu_torch.data import jpeg  # noqa: E402
from long_video_gan_tpu_torch.data.dataset import VideoDataset, VideoDatasetTwoRes  # noqa: E402
from long_video_gan_tpu_torch.data.loader import InfiniteLoader  # noqa: E402
from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset  # noqa: E402
from long_video_gan_tpu_torch.utils.profiling import gpu_name_and_power_limit  # noqa: E402

WARMUP = 2
SRES = dict(batch=32, seq_length=4 + 2 * 4)      # train_sres full preset
LRES = dict(batch=64, seq_length=128)            # train_lres full preset
DECODERS = {"native": jpeg.decode_jpeg_batch, "pil": jpeg._decode_batch_pil}


def rate(dataset, batch: int, workers: int, batches: int, seed: int, decoder: str) -> dict:
    dataset_module.decode_jpeg_batch = DECODERS[decoder]
    loader = InfiniteLoader(dataset, batch, seed=seed, num_workers=workers, prefetch=4)
    try:
        for _ in range(WARMUP):
            next(loader)
        start = time.perf_counter()
        for _ in range(batches):
            last = next(loader)
        seconds = time.perf_counter() - start
    finally:
        loader.close()
        dataset_module.decode_jpeg_batch = jpeg.decode_jpeg_batch
    shapes = {k: list(v.shape) for k, v in last.items() if hasattr(v, "shape")}
    return {"decoder": decoder, "workers": workers, "batches": batches, "seconds": round(seconds, 4),
            "batches_per_s": round(batches / seconds, 4),
            "sec_per_batch": round(seconds / batches, 4), "shapes": shapes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=lambda t: [int(v) for v in t.split(",")], default=[4, 8])
    ap.add_argument("--batches", type=int, default=8, help="timed batches per configuration")
    ap.add_argument("--videos", type=int, default=16, help="videos in the synthetic dataset")
    ap.add_argument("--decoders", type=lambda t: t.split(","), default=["native", "pil"],
                    help="decoders to time in turn at each configuration: native, pil")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if set(args.decoders) - set(DECODERS):
        ap.error(f"--decoders takes {', '.join(DECODERS)}")
    decoder = jpeg.decoder_in_use()
    print(f"decoder: {decoder}; host cores: {os.cpu_count()}; card: "
          f"{gpu_name_and_power_limit() or 'none'}", flush=True)
    if "native" in args.decoders and not decoder.startswith("native"):
        raise RuntimeError("the native decoder did not load; time --decoders pil alone")
    with tempfile.TemporaryDirectory() as root:
        start = time.perf_counter()
        make_synthetic_dataset(root, [(36, 64), (144, 256)], num_videos=args.videos,
                               frames_per_video=LRES["seq_length"] + 16, num_partitions=2,
                               seed=args.seed)
        print(f"dataset: {args.videos} videos of {LRES['seq_length'] + 16} frames at 36x64 "
              f"and 144x256 in {time.perf_counter() - start:.1f} s", flush=True)
        datasets = {
            "sres": (VideoDatasetTwoRes(root, SRES["seq_length"], 36, 64, 144, 256, x_flip=True),
                     SRES["batch"]),
            "lres": (VideoDataset(root, LRES["seq_length"], 36, 64, x_flip=True), LRES["batch"]),
        }
        for kind, (dataset, batch) in datasets.items():
            for workers in args.workers:
                for decoder in args.decoders:
                    record = {"config": kind, "batch": batch,
                              **rate(dataset, batch, workers, args.batches, args.seed, decoder)}
                    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
