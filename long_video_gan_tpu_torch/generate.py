"""Two-stage long-video generation: the port's main path, and its CLI.

Counterpart of the repository's `generate.py`: synthesize the whole low-res
video in one pass (length rounded up to a segment multiple plus the sres
temporal context), then stream the super-resolution through sliding windows
with a shared z.

    python -m long_video_gan_tpu_torch.generate --lres lres.lvg --sres sres.lvg \\
        --output out.mp4 --frames 301

`--lres` and `--sres` take a path or a URL: `file://`, or http(s), which
downloads once into the port's cache (`utils/fetch.py`).

The same seed gives other frames than the JAX package's `generate.py`: torch
generators and JAX's threefry keys draw different numbers.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Iterator, Optional

import torch

from .models import generator_lres, generator_sres
from .utils.misc import cli_device


def lres_length(num_frames: int, segment_length: int, temporal_context: int) -> int:
    """Low-res frames to synthesize: `num_frames` rounded up to a segment
    multiple, plus the sres context halo on both ends."""
    return -(-num_frames // segment_length) * segment_length + 2 * temporal_context


@torch.inference_mode()
def synthesize_lres(lres_G: generator_lres.VideoGenerator, lr_len: int, *, batch_size: int,
                    generator: torch.Generator, device: torch.device,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole [batch, 3, lr_len, h, w] low-res video in one pass, from
    injected white `noise` (shape `lres_G.noise_shape(batch_size, lr_len)`) or
    noise drawn from `generator`."""
    if noise is None:
        noise = torch.randn(lres_G.noise_shape(batch_size, lr_len), generator=generator,
                            device=generator.device)
    return lres_G(batch_size, lr_len, noise=noise.to(device))


@torch.inference_mode()
def super_resolve(sres_G: generator_sres.VideoGenerator, lr_video: torch.Tensor,
                  num_frames: int, *, segment_length: int = 16, truncation_psi: float = 1.0,
                  prefetch: int = 1, generator: torch.Generator,
                  z: Optional[torch.Tensor] = None) -> Iterator[torch.Tensor]:
    """Stream the hr video of `lr_video` (which holds the context halo) in
    segments with one z per video (injected, or drawn from `generator`); the
    last segment is cut to `num_frames` in all.

    On a CUDA `lr_video` each segment is computed on the device's synthesis
    stream (`generator_sres.sample_video_segments`), `prefetch` windows
    ahead, and the consumer's current stream waits for that segment alone
    when it is yielded: a `.cpu()` of it returns once it is done, without
    waiting for the prefetched windows, which compute while it copies."""
    if z is None:
        z = torch.randn((lr_video.shape[0], sres_G.latent_z_dim), generator=generator,
                        device=generator.device)
    written = 0
    for seg in generator_sres.sample_video_segments(
            sres_G, lr_video, segment_length=segment_length,
            temporal_context=sres_G.temporal_context, z=z.to(lr_video.device),
            prefetch=prefetch, truncation_psi=truncation_psi):
        keep = min(seg.shape[2], num_frames - written)
        if keep <= 0:
            break
        written += keep
        yield seg[:, :, :keep]


def generate_video(lres_G: generator_lres.VideoGenerator,
                   sres_G: generator_sres.VideoGenerator, num_frames: int, *,
                   segment_length: int = 16, batch_size: int = 1,
                   truncation_psi: float = 1.0, prefetch: int = 1,
                   generator: torch.Generator, device: torch.device,
                   noise: Optional[torch.Tensor] = None,
                   z: Optional[torch.Tensor] = None) -> Iterator[torch.Tensor]:
    """Yield [batch, 3, <=segment_length, hr_h, hr_w] segments on `device`,
    `num_frames` frames in all: `synthesize_lres`, then `super_resolve`.
    Random draws come from `generator`, the lres noise first, then z."""
    lr_len = lres_length(num_frames, segment_length, sres_G.temporal_context)
    lr_video = synthesize_lres(lres_G, lr_len, batch_size=batch_size, generator=generator,
                               device=device, noise=noise)
    yield from super_resolve(sres_G, lr_video, num_frames, segment_length=segment_length,
                             truncation_psi=truncation_psi, prefetch=prefetch,
                             generator=generator, z=z)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lres", dest="lres_path", required=True,
                    help="lres G_ema checkpoint: a path or a URL")
    ap.add_argument("--sres", dest="sres_path", default=None,
                    help="sres G_ema checkpoint: a path or a URL")
    ap.add_argument("--output", required=True, help="Output mp4 path")
    ap.add_argument("--seed", type=int, default=49)
    ap.add_argument("--frames", dest="num_frames", type=int, default=301)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--batch", dest="batch_size", type=int, default=1)
    ap.add_argument("--segment-length", type=int, default=16)
    ap.add_argument("--save-lres", action="store_true", help="Also write the low-res video")
    ap.add_argument("--save-frames", action="store_true", help="Write per-frame PNGs")
    ap.add_argument("--save-index", "-i", dest="save_frame_indices", type=int,
                    action="append", default=[],
                    help="Frame index to also save as a PNG (repeatable)")
    ap.add_argument("--truncation-psi", type=float, default=1.0)
    ap.add_argument("--prefetch", type=int, default=1,
                    help="sres segments enqueued ahead of the one being written")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    from .io.checkpoint import load_generator
    from .utils.fetch import resolve_path
    from .utils.video import save_image_grid, write_video_grid

    out_path = Path(args.output)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    # A URL checkpoint (file://, or http(s) already in the cache) resolves
    # to a local file first, as in the JAX package's CLI.
    lres_G, _ = load_generator(resolve_path(args.lres_path), device)
    sres_G = (load_generator(resolve_path(args.sres_path), device)[0] if args.sres_path
              else None)
    indices = sorted({i for i in args.save_frame_indices if 0 <= i < args.num_frames})

    def save_indexed_frame(frame_nchw, index):
        frame_out = out_path.with_name(f"{out_path.stem}-frame{index:04d}.png")
        save_image_grid(frame_nchw, frame_out)
        print(f"Wrote {frame_out}")

    context = 0 if sres_G is None else sres_G.temporal_context
    lr_len = lres_length(args.num_frames, args.segment_length, context)
    print(f"Generating {lr_len}-frame low-res video ...")
    lr_video = synthesize_lres(lres_G, lr_len, batch_size=args.batch_size, generator=gen,
                               device=device)
    if sres_G is None or args.save_lres:
        lr_frames = lr_video[:, :, context:context + args.num_frames].cpu().numpy()
        lr_out = out_path.with_name(out_path.stem + "-lres" + out_path.suffix)
        write_video_grid(lr_frames, lr_out, fps=args.fps)
        print(f"Wrote {lr_out}")
        if sres_G is None:
            for i in indices:
                save_indexed_frame(lr_frames[:, :, i], i)
            return

    print(f"Super-resolving in segments of {args.segment_length} ...")
    segments = []
    written = 0
    frames_dir = out_path.with_suffix("") if args.save_frames else None
    for seg in super_resolve(sres_G, lr_video, args.num_frames,
                             segment_length=args.segment_length,
                             truncation_psi=args.truncation_psi, prefetch=args.prefetch,
                             generator=gen):
        seg = seg.cpu().numpy()
        segments.append(seg)
        if frames_dir is not None:
            frames_dir.mkdir(parents=True, exist_ok=True)
            for t in range(seg.shape[2]):
                save_image_grid(seg[:, :, t], frames_dir / f"{written + t:06d}.png")
        for i in indices:
            if written <= i < written + seg.shape[2]:
                save_indexed_frame(seg[:, :, i - written], i)
        written += seg.shape[2]
        print(f"  {written}/{args.num_frames} frames")

    write_video_grid(iter(segments), out_path, fps=args.fps)
    print(f"Wrote {out_path}")


if __name__ == "__main__":
    main()
