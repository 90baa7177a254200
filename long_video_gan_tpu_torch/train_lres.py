"""Stage-1 (low-resolution) training: the port's trainer CLI.

Counterpart of the repository's `train_lres.py`: batch 64 of 128-frame 36x64
clips, G with `temporal_emb_dim=1024` and `temporal_padding=8`, D with
`channels_max=512`, DiffAugment `color,translation,cutout`, temporal scale
augment 1.0 and a random temporal translate of the fakes, R1 every 16 steps
with the lazy-regularization lr and beta2 correction; the `tiny` preset
shrinks everything for a CPU smoke run. Beside the run directory that
`train.run` writes, the samples are `samples/real-long.mp4` and
`samples/fake-<step>.mp4` (`result_seq_length` frames from G_ema), and
`--metric` scores G_ema on its own.

    python -m long_video_gan_tpu_torch.train_lres --dataset datasets/horseback \\
        --outdir runs/lres --batch 64 --grad-accum 4 --gamma 1 --device cuda
    python -m long_video_gan_tpu_torch.train_lres --dataset data --preset tiny \\
        --batch 4 --device cpu
    python -m long_video_gan_tpu_torch.train_lres ... --resume ckpt-00000400-train.lvg
    python -m long_video_gan_tpu_torch.train_lres ... -m fvd2048_128f --metric-detector stub:64

`--block-remat` recomputes each of G's residual blocks. Not ported:
`--unroll-accum`, the unroll factor of the JAX accumulation `scan` (the
port accumulates in a Python loop), and `--wandb`.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .train import run
from .train.gan_lres import LowResVideoGAN


def build_config(dataset_dir: str, total_batch: int, grad_accum: int, r1_gamma: float,
                 preset: str, fp16_layers: int = 0, d_fp16_res: int = 0, remat: bool = False,
                 block_remat: bool = False) -> dict:
    """The `full` and `tiny` presets of the repository's `train_lres.py`,
    with its `--remat` and `--block-remat` at `gan_kwargs.remat` and
    `gan_kwargs.G_kwargs.block_remat`."""
    c = dict(
        dataset_dir=dataset_dir,
        seq_length=128, height=36, width=64, x_flip=True,
        total_steps=100_000, steps_per_tick=500,
        ticks_per_G_ema_ckpt=10, ticks_per_train_ckpt=100,
        result_seq_length=256, r1_interval=16, total_batch=total_batch,
        loader_kwargs=dict(num_workers=8, prefetch=4),
    )
    gan = dict(
        D_lrate=0.002, D_beta2=0.99, r1_gamma=r1_gamma,
        G_random_temp_translate=True, temp_scale_augment=1.0,
        G_grad_accum=grad_accum, D_grad_accum=grad_accum, remat=remat,
        G_kwargs=dict(num_fp16_layers=fp16_layers, temporal_padding=8, temporal_emb_dim=1024,
                      block_remat=block_remat),
        D_kwargs=dict(num_fp16_res=d_fp16_res),
    )
    if c["r1_interval"] > 0:
        # Lazy-regularization lr/beta correction.
        mb_ratio = c["r1_interval"] / (c["r1_interval"] + 1)
        gan["D_lrate"] *= mb_ratio
        gan["D_beta2"] **= mb_ratio
    if preset == "tiny":
        c.update(seq_length=8, height=8, width=16, total_steps=4, steps_per_tick=2,
                 ticks_per_G_ema_ckpt=1, ticks_per_train_ckpt=2, result_seq_length=16,
                 r1_interval=2)
        gan["G_kwargs"].update(
            temporal_emb_dim=64, latent_w_dim=64, temporal_padding=2, channel_max=32,
            embedding_kwargs=dict(min_sampling_rate=10, max_sampling_rate=40, blur_widths=16))
        gan["D_kwargs"].update(channels_max=32, epilogue_kwargs=dict(channels=64))
    elif preset != "full":
        raise ValueError(f"unknown preset {preset!r}")
    c["gan_kwargs"] = gan
    return c


def make_gan(c: dict, device: torch.device) -> LowResVideoGAN:
    return LowResVideoGAN(seq_length=c["seq_length"], height=c["height"], width=c["width"],
                          total_batch=c["total_batch"], **copy.deepcopy(c["gan_kwargs"]),
                          device=device)


def generator_config(c: dict) -> dict:
    """The `.lvg` header of a G_ema checkpoint: kind and constructor kwargs."""
    return dict(kind="generator_lres",
                kwargs=dict(out_height=c["height"], out_width=c["width"],
                            **c["gan_kwargs"]["G_kwargs"]))


def train_step(gan: LowResVideoGAN, generator: torch.Generator, c: dict, step: int,
               batches: Iterator[torch.Tensor]) -> list[dict]:
    """One training step on the reference schedule: G, D, R1 every
    `r1_interval` steps (gain r1_interval), then the G_ema update. `batches`
    yields real [batch, 3, seq_length, height, width] videos on the
    trainer's device. Returns the phases' statistics."""
    out = [gan.update_G(generator), gan.update_D(generator, next(batches))]
    if c["r1_interval"] > 0 and step % c["r1_interval"] == 0:
        out.append(gan.update_r1(generator, next(batches), gain=float(c["r1_interval"])))
    gan.update_G_ema()
    return out


def _write_samples(c: dict, seed: int, device: torch.device,
                   samples_dir: Path) -> Callable[[torch.nn.Module, int, torch.Generator], None]:
    """Write `real-long.mp4`, a `result_seq_length`-frame clip of the
    dataset; returns the writer of `fake-<step>.mp4`, as long from G_ema."""
    from .data.dataset import VideoDataset
    from .models.generator_lres import sample_video_segments
    from .utils.video import write_video_grid

    real = VideoDataset(c["dataset_dir"], c["result_seq_length"], c["height"], c["width"],
                        x_flip=c["x_flip"]).sample(0, np.random.default_rng(seed))["video"]
    write_video_grid(real[None], samples_dir / "real-long.mp4")

    def write_fake(G_ema: torch.nn.Module, step: int, generator: torch.Generator) -> None:
        segments = sample_video_segments(G_ema, 1, c["result_seq_length"], generator=generator)
        write_video_grid((s.cpu().numpy() for s in segments), samples_dir / f"fake-{step:08d}.mp4")

    return write_fake


def train(c: dict, run_dir: str, seed: int, device: torch.device,
          resume: Optional[str] = None) -> None:
    """`train.run.train` on the video dataset of `c` (`build_config`'s)."""
    from .data.dataset import VideoDataset

    print(f"Loading video dataset from {c['dataset_dir']} ...")
    dataset = VideoDataset(c["dataset_dir"], c["seq_length"], c["height"], c["width"],
                           x_flip=c["x_flip"])
    run.train(c, run_dir, seed, device, resume, gan_name="low res", dataset=dataset,
              to_batch=lambda sample: torch.from_numpy(sample["video"]).to(device),
              make_gan=make_gan, train_step=train_step, G_config=generator_config(c),
              write_samples=_write_samples,
              metric_kwargs=dict(dataset_kwargs=dict(dataset_dir=c["dataset_dir"], seq_length=1,
                                                     height=c["height"], width=c["width"])))


def main(argv: Optional[list[str]] = None) -> str:
    """Parse the options, make the run directory, train; returns the run
    directory."""
    return run.main(
        argv, description="Train a low-resolution LongVideoGAN network with the PyTorch port.",
        outdir="runs/lres", batch=64, grad_accum=2,
        grad_accum_help="micro-batches per step of each process. Pass 4 for the full preset at "
                        "batch 64 in f32 on one 80 GB H100: the default 2 (the reference's) "
                        "runs out of memory there.",
        options=[("--fp16-layers", dict(type=int, default=0,
                                         help="run the last N generator layers in bfloat16")),
                 ("--d-fp16-res", dict(type=int, default=0,
                                        help="run the first N discriminator blocks in "
                                             "bfloat16"))],
        config=lambda a: build_config(a.dataset_dir, a.total_batch, a.grad_accum, a.r1_gamma,
                                      a.preset, a.fp16_layers, a.d_fp16_res, a.remat,
                                      a.block_remat),
        train=train)


if __name__ == "__main__":
    main()
