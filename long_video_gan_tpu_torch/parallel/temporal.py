"""Temporal (sequence) sharding: long lres videos synthesized across processes.

Counterpart of `long_video_gan_tpu/parallel/temporal.py`. Every temporal
operator of the lres generator (the noise blur, the tent and Kaiser
resamplers, the 3D convs, the center crops) is shift-equivariant for shifts
that are multiples of `total_temporal_scale`, and its boundary effects are
bounded by explicit temporal halos. So a window synthesized from the right
slice of the one noise stream reproduces the whole video's synthesis in its
interior. Each process:

  1. draws the whole white-noise stream from the generator every process
     holds alike (about 8 floats per frame against thousands of output
     pixels);
  2. slices its window's noise span (window + the blur kernel's halo);
  3. synthesizes window + 2 * halo frames;
  4. keeps the interior `shard_len` frames;

and an all_gather along time gives every process the whole video, as the JAX
function's global array is whole. The default halo is 8 *
total_temporal_scale, at the float noise floor in the JAX package's
measurement (2 * scale: 2e-3, 4 * scale: 1e-5, 8 * scale: 4e-7).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..models.generator_lres import VideoGenerator
from .multihost import rank, world_size


def _window_video_from_noise(G: VideoGenerator, noise_window: torch.Tensor,
                             window_len: int) -> torch.Tensor:
    """Synthesize `window_len` output frames from the window's noise span
    [N, noise_channels, G.noise_shape(N, window_len)[2]]."""
    return G(noise_window.shape[0], window_len, noise=noise_window)


def synthesize_time_sharded(G: VideoGenerator, batch_size: int, seq_length: int,
                            generator: torch.Generator, halo: Optional[int] = None
                            ) -> torch.Tensor:
    """Synthesize a [batch, 3, seq_length, H, W] lres video with its time
    axis split over the processes; the whole video on every process.

    seq_length must be divisible by world_size * total_temporal_scale so
    every shard boundary is phase-aligned with all stride-2 temporal chains.
    """
    scale = G.total_temporal_scale
    num_shards = world_size()
    halo = 8 * scale if halo is None else halo
    assert halo % scale == 0, f"halo must be a multiple of {scale}"
    assert seq_length % (num_shards * scale) == 0, (
        f"seq_length must be divisible by num_shards*total_temporal_scale "
        f"({num_shards}*{scale})")
    shard_len = seq_length // num_shards
    window_len = shard_len + 2 * halo

    # Window w starts at output frame w * shard_len - halo; its noise span
    # starts there too (same rate) and the blur takes kernel_size - 1 more.
    noise_len_w = G.noise_shape(batch_size, window_len)[2]
    total_noise = (num_shards - 1) * shard_len + noise_len_w
    noise = torch.randn((batch_size, G.noise_channels, total_noise), generator=generator,
                        device=generator.device)
    start = rank() * shard_len
    window = noise[:, :, start:start + noise_len_w]
    video = _window_video_from_noise(G, window, window_len)[:, :, halo:halo + shard_len]
    if num_shards == 1:
        return video
    parts = [torch.empty_like(video) for _ in range(num_shards)]
    dist.all_gather(parts, video.contiguous())
    return torch.cat(parts, dim=2)
