"""Color similarity against frame separation, generated and real: the port's
counterpart of the repository's `plot_color_similarity.py` (the paper's
long-horizon color-drift figure).

The similarity of frame 0 and frame t is the intersection of their joint RGB
histograms (bins_per_color^3 bins), averaged over videos with a +-1 std
band. Generated videos come from the lres G (and the sres G, streamed in
16-frame segments, with `--sres`), real ones from the dataset at the output
resolution.

    python -m long_video_gan_tpu_torch.plot_color_similarity --path fig.pdf \\
        --dataset datasets/horseback --lres lres.lvg --sres sres.lvg
    python -m long_video_gan_tpu_torch.plot_color_similarity --path fig.png \\
        --dataset data --lres lres.lvg --len 16 --samples 4 --batch 2 --device cpu

The generated videos differ from the JAX package's tool's: torch generators
and JAX's threefry keys draw different numbers from the same seeds.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from .utils.misc import cli_device

SEGMENT_LENGTH = 16


def video_color_intersection(video: np.ndarray, bins_per_color: int = 20) -> np.ndarray:
    """video [C, T, H, W] in [-1, 1] -> similarity[t] between frame 0 and
    frame t+1 (histogram intersection of joint RGB histograms)."""
    assert video.ndim == 4 and video.shape[0] == 3
    c, t, h, w = video.shape
    num_pixels = h * w
    x = (video / 2 + 0.5) * (bins_per_color - 1)
    x = np.clip(np.floor(x + 0.5), 0, bins_per_color - 1).astype(np.int64)
    joint = (x[0] * bins_per_color + x[1]) * bins_per_color + x[2]     # [T, H, W]
    bins = bins_per_color ** 3
    hists = np.stack([np.bincount(f.ravel(), minlength=bins) for f in joint])
    inter = np.minimum(hists[1:], hists[:1]).sum(axis=1)
    return inter / num_pixels


def accumulate(videos, bins_per_color: int = 20) -> tuple[np.ndarray, np.ndarray]:
    """Mean and std over `videos` of `video_color_intersection`."""
    n = 0
    s = 0.0
    ss = 0.0
    for video in videos:
        sim = video_color_intersection(np.asarray(video), bins_per_color)
        n += 1
        s = s + sim
        ss = ss + sim ** 2
    mean = s / n
    std = np.sqrt(np.maximum((ss - n * mean ** 2) / max(n - 1, 1), 0))
    return mean, std


def generated_videos(lres_G, sres_G, num_samples: int, batch_size: int, seq_length: int,
                     device: torch.device) -> Iterator[np.ndarray]:
    """`num_samples` rounded up to whole batches of [3, seq_length, h, w]
    videos: the lres G's whole video, super-resolved in 16-frame segments
    with one z per video where `sres_G` is given."""
    from .generate import synthesize_lres
    from .models.generator_sres import sample_video_segments

    lr_len = -(-seq_length // SEGMENT_LENGTH) * SEGMENT_LENGTH
    if sres_G is not None:
        lr_len += 2 * sres_G.temporal_context
    gen = torch.Generator().manual_seed(0)
    for _ in range(math.ceil(num_samples / batch_size)):
        lr = synthesize_lres(lres_G, lr_len, batch_size=batch_size, generator=gen,
                             device=device)
        if sres_G is None:
            video = lr[:, :, :seq_length]
        else:
            z = torch.randn((batch_size, sres_G.latent_z_dim), generator=gen).to(device)
            with torch.inference_mode():
                video = torch.cat(list(sample_video_segments(
                    sres_G, lr, SEGMENT_LENGTH, sres_G.temporal_context, z=z)),
                    dim=2)[:, :, :seq_length]
        yield from video.float().cpu().numpy()


def real_videos(dataset, num_samples: int) -> Iterator[np.ndarray]:
    """`num_samples` random clips of the dataset (the JAX tool's draws)."""
    rng = np.random.default_rng(0)
    for _ in range(num_samples):
        yield dataset.sample(int(rng.integers(len(dataset))), rng)["video"]


def _plot_series(plt, mean, std, label, color):
    xs = np.arange(mean.shape[0] + 1)
    mean = np.concatenate([[1.0], mean])
    std = np.concatenate([[0.0], std])
    plt.plot(xs, mean, label=label, color=color)
    plt.fill_between(xs, mean - std, mean + std, alpha=0.2, color=color, linewidth=0, zorder=-10)
    plt.plot(xs[-1], mean[-1], marker="o", markersize=4, color=color, zorder=10)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", required=True, help="Output image path (pdf/png)")
    ap.add_argument("--dataset", dest="dataset_dir", required=True)
    ap.add_argument("--lres", dest="lres_path", required=True, help="lres G_ema checkpoint")
    ap.add_argument("--sres", dest="sres_path", default=None, help="sres G_ema checkpoint")
    ap.add_argument("--len", dest="seq_length", type=int, default=128)
    ap.add_argument("--samples", dest="num_samples", type=int, default=1000)
    ap.add_argument("--batch", dest="batch_size", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .data.dataset import VideoDataset
    from .io.checkpoint import load_generator
    from .utils.fetch import resolve_path

    lres_G, _ = load_generator(resolve_path(args.lres_path), device)
    sres_G = (load_generator(resolve_path(args.sres_path), device)[0] if args.sres_path
              else None)
    seq_length = args.seq_length + 1
    if sres_G is not None:
        height, width = sres_G.hr_height, sres_G.hr_width
    else:
        height, width = lres_G.out_height, lres_G.out_width
    dataset = VideoDataset(args.dataset_dir, seq_length, height, width)

    print("Computing color intersection for generated videos ...")
    gen_mean, gen_std = accumulate(generated_videos(
        lres_G, sres_G, args.num_samples, args.batch_size, seq_length, device))
    print("Computing color intersection for dataset videos ...")
    real_mean, real_std = accumulate(real_videos(dataset, args.num_samples))

    Path(args.path).parent.mkdir(parents=True, exist_ok=True)
    plt.figure(figsize=(5, 3), dpi=200)
    plt.xlabel("Frame separation")
    plt.ylabel("Color similarity")
    plt.gca().spines["top"].set_visible(False)
    plt.gca().spines["right"].set_visible(False)
    _plot_series(plt, gen_mean, gen_std, "LongVideoGAN (PyTorch)", "tab:blue")
    _plot_series(plt, real_mean, real_std, "Dataset", "tab:orange")
    plt.xlim(0, seq_length + 2)
    plt.ylim(0, 1)
    plt.legend(loc="upper right", frameon=False)
    plt.tight_layout()
    plt.savefig(args.path)
    print(f"Saved plot {args.path}")


if __name__ == "__main__":
    main()
