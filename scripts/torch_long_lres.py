"""One long low-res video from the PyTorch port on one NVIDIA GPU: the port's
lres `VideoGenerator` at its defaults (36x64), seeded random weights, through
`long_video_gan_tpu_torch.generate.synthesize_lres` in one pass, batch 1.

At about 7,300 frames one of its activations (the up-sampled input of the
third spatial block, 128 x 36 x 64 per frame) passes 2**31 elements, where
CUDA kernels that index with 32-bit ints go wrong. The script times the long
pass (PyTorch's default flags: cuDNN convolutions in TF32) and reads its
peak device memory. Then, with TF32 off, it runs the long pass again and
holds its first and last frames to short passes over the same noise: every
temporal operator is shift-equivariant for shifts that are multiples of
`total_temporal_scale`, so a window synthesized from the matching slice of
the noise reproduces the long video away from the window's own open edge
(8 * total_temporal_scale frames, the halo of the JAX package's
`parallel/temporal.py`). It prints the card, one JSON line and exits 0 only
if the video is finite, of the expected shape, and agrees within `TOL`.

    python3 scripts/torch_long_lres.py --frames 8192
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

WINDOW = 512     # frames of each short pass
TOL = 1e-4       # relative max-abs, long pass vs window in f32 (the halo leaves ~1e-6)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_long_lres: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from long_video_gan_tpu_torch import selftest
    from long_video_gan_tpu_torch.generate import synthesize_lres
    from long_video_gan_tpu_torch.models import generator_lres
    from long_video_gan_tpu_torch.models.common import init_weights_

    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    G = init_weights_(generator_lres.VideoGenerator(device=device),
                      torch.Generator().manual_seed(args.seed)).eval().requires_grad_(False)
    scale = G.total_temporal_scale
    halo = 8 * scale
    if args.frames % scale or args.frames < 2 * WINDOW:
        raise ValueError(f"--frames must be a multiple of {scale} and at least {2 * WINDOW}")
    noise = torch.randn(G.noise_shape(1, args.frames),
                        generator=torch.Generator().manual_seed(args.seed + 1))

    def run(frames: int, start: int = 0) -> torch.Tensor:
        window = noise[:, :, start:start + G.noise_shape(1, frames)[2]]
        with torch.inference_mode():
            return synthesize_lres(G, frames, batch_size=1, generator=None, device=device,
                                   noise=window)

    run(WINDOW)   # warm-up: cuDNN's algorithm choice and the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    video = run(args.frames)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    finite = bool(torch.isfinite(video).all())
    shape = list(video.shape)
    del video
    # The first frames against a pass from the start, the last against one
    # that ends where the long pass ends; each window's open edge left out.
    tail = args.frames - WINDOW
    with selftest.tf32_off():
        video = run(args.frames)
        pairs = {"head": (video[:, :, :WINDOW - halo], run(WINDOW)[:, :, :WINDOW - halo]),
                 "tail": (video[:, :, tail + halo:], run(WINDOW, tail)[:, :, halo:])}
        errs = {k: ((a - b).abs().max() / b.abs().max()).item() for k, (a, b) in pairs.items()}
    ok = (finite and shape == [1, 3, args.frames, G.out_height, G.out_width]
          and all(e <= TOL for e in errs.values()))
    print(json.dumps({"frames": args.frames, "shape": shape, "seconds": seconds,
                      "frames_per_s": args.frames / seconds, "peak_gib": peak_gib,
                      "finite": finite, "rel_err": errs, "tol": TOL, "ok": ok,
                      "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
