"""Streaming-synthesis prefetch sweep of the PyTorch port's sres
`sample_video_segments` on one NVIDIA GPU.

Times the streaming path `generate` runs (unfold the lr video into windows,
synthesize each hr segment, the consumer fetches each to the host) at each
prefetch depth of `--depths`, the knob `generate --prefetch` exposes: with
depth d, d segments are enqueued on the device ahead of the one the host is
copying. The sres G is the `bench.py` geometry (36x64 -> 144x256, context 4,
`num_fp16_res=4`, `resample_impl="auto"`: K1 on its bf16 layers) with seeded
random weights; the lr video is seeded noise of `--segments` segments plus
the context. Each depth's value is the best of `--iters` wall times, after
one warm-up run. Prints the card and one JSON line per depth.

    python3 scripts/torch_bench_prefetch.py
    python3 scripts/torch_bench_prefetch.py --depths 0 --segments 1 --iters 1 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from long_video_gan_tpu_torch.models.common import init_weights_  # noqa: E402
from long_video_gan_tpu_torch.models.generator_sres import (VideoGenerator,  # noqa: E402
                                                            sample_video_segments)
from long_video_gan_tpu_torch.utils.misc import cli_device  # noqa: E402

METRIC = "sres_streaming_frames_per_sec_256x144"
CONTEXT = 4
SRES_KWARGS = dict(hr_height=144, hr_width=256, lr_height=36, lr_width=64,
                   temporal_context=CONTEXT, num_fp16_res=4, resample_impl="auto")


def streaming_inputs(segments: int, segment_length: int, device, seed: int = 0, **G_kwargs):
    """(the sres G with weights from `seed`, an lr video of `segments`
    segments plus the context, z) on `device`."""
    gen = torch.Generator().manual_seed(seed)
    G = init_weights_(VideoGenerator(**{**SRES_KWARGS, **G_kwargs}, device=device), gen)
    G.eval().requires_grad_(False)
    lr_video = 0.2 * torch.randn((1, 3, segments * segment_length + 2 * G.temporal_context,
                                  G.lr_height, G.lr_width), generator=gen).to(device)
    z = torch.randn((1, G.latent_z_dim), generator=gen).to(device)
    return G, lr_video, z


@torch.inference_mode()
def stream_seconds(G, lr_video, z, segment_length: int, depth: int) -> float:
    """Wall seconds to stream every segment and fetch it to the host."""
    start = time.perf_counter()
    frames = 0
    for hr in sample_video_segments(G, lr_video, segment_length=segment_length,
                                    temporal_context=G.temporal_context, z=z, prefetch=depth):
        frames += hr.cpu().shape[2]   # the host fetch is the consumer's work
    seconds = time.perf_counter() - start
    if frames != lr_video.shape[2] - 2 * G.temporal_context:
        raise RuntimeError(f"streamed {frames} frames of {lr_video.shape[2]} lr frames")
    return seconds


def sweep(G, lr_video, z, segment_length: int, depths, iters: int) -> list[dict]:
    """One warm-up run at depth 1, then each depth's record."""
    stream_seconds(G, lr_video, z, segment_length, 1)
    frames = lr_video.shape[2] - 2 * G.temporal_context
    out = []
    for depth in depths:
        times = [stream_seconds(G, lr_video, z, segment_length, depth) for _ in range(iters)]
        out.append({"metric": METRIC, "prefetch": depth, "value": frames / min(times),
                    "unit": "frames/s", "wall_sec": times})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="0,1,2")
    ap.add_argument("--segments", type=int, default=8,
                    help="segments per timed run (video length = segments * segment length)")
    ap.add_argument("--segment-length", type=int, default=16)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    from long_video_gan_tpu_torch.utils.profiling import gpu_name_and_power_limit

    card = gpu_name_and_power_limit(device)
    print(card or "cpu")
    G, lr_video, z = streaming_inputs(args.segments, args.segment_length, device)
    for record in sweep(G, lr_video, z, args.segment_length,
                        [int(d) for d in args.depths.split(",")], args.iters):
        print(json.dumps({**record, "device": card or "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
