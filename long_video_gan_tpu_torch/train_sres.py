"""Stage-2 (super-resolution) training: the port's trainer CLI.

Counterpart of the repository's `train_sres.py`: batch 32 of paired 36x64 /
144x256 clips of 4 (+ 2 x 4 context) frames, ADA every 4 steps, R1 every 16,
the full-strength ADA configuration; the `tiny` preset shrinks everything for
a CPU smoke run. The same lr batch conditions both the fake and the real
branch of the D step, as in the reference. Data comes through the port's
`data` package (ZIP shards of JPEG frames). Beside the run directory that
`train.run` writes, the samples are `samples/real-lr.mp4`,
`samples/real-hr.mp4` and `samples/fake-<step>-hr.mp4` (G_ema on the real lr
clip, in 8-frame segments with its temporal context), and `--metric` scores
G_ema on real lr clips of the dataset (the cond-dataset protocol).

    python -m long_video_gan_tpu_torch.train_sres --dataset datasets/horseback \\
        --outdir runs/sres --batch 32 --grad-accum 2 --device cuda
    python -m long_video_gan_tpu_torch.train_sres --dataset data --preset tiny \\
        --batch 4 --device cpu
    python -m long_video_gan_tpu_torch.train_sres ... --resume ckpt-00000400-train.lvg
    python -m long_video_gan_tpu_torch.train_sres ... -m fvd2048_16f --metric-detector stub:64

The JAX CLI records `--matmul-precision` in `config.json` without applying
it; the port applies it. `--block-remat` recomputes each of G's synthesis
layers. wandb is not ported.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .train import run
from .train.gan_sres import SuperResVideoGAN


def build_config(dataset_dir: str, total_batch: int, grad_accum: int, r1_gamma: float,
                 preset: str, remat: bool = False, block_remat: bool = False) -> dict:
    """The `full` and `tiny` presets of the repository's `train_sres.py`,
    with its `--remat` and `--block-remat` at `gan_kwargs.remat` and
    `gan_kwargs.G_kwargs.block_remat`."""
    c = dict(
        dataset_dir=dataset_dir,
        seq_length=4, temporal_context=4,
        lr_height=36, lr_width=64, hr_height=144, hr_width=256,
        x_flip=True,
        total_steps=275_000, steps_per_tick=500, ticks_per_G_ema_ckpt=10,
        ticks_per_train_ckpt=100, result_seq_length=256,
        r1_interval=16, ada_interval=4, total_batch=total_batch,
        loader_kwargs=dict(num_workers=8, prefetch=4),
    )
    gan = dict(
        D_lrate=0.003, D_beta2=0.99, lr_cond_prob=0.1, r1_gamma=r1_gamma,
        in_augment_p=0.5, in_augment_strength=8,
        G_grad_accum=grad_accum, D_grad_accum=grad_accum, remat=remat,
        G_kwargs=dict(num_fp16_res=4, fourfeats=False, resample_impl="auto",
                      block_remat=block_remat),
        D_kwargs=dict(num_fp16_res=4),
        augment_kwargs=dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
                            brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
    )
    if c["r1_interval"] > 0:
        mb_ratio = c["r1_interval"] / (c["r1_interval"] + 1)
        gan["D_lrate"] *= mb_ratio
        gan["D_beta2"] **= mb_ratio
    if preset == "tiny":
        c.update(seq_length=2, temporal_context=2, lr_height=8, lr_width=16,
                 hr_height=32, hr_width=64, total_steps=4, steps_per_tick=2,
                 ticks_per_G_ema_ckpt=1, ticks_per_train_ckpt=2, result_seq_length=8,
                 r1_interval=2, ada_interval=2)
        gan["G_kwargs"].update(latent_z_dim=32, latent_w_dim=32, margin_size=4,
                               num_fp16_res=0, channel_base=1024, channel_max=32, num_layers=6)
        gan["D_kwargs"].update(channels_base=512, channels_max=32, num_fp16_res=0)
    elif preset != "full":
        raise ValueError(f"unknown preset {preset!r}")
    c["gan_kwargs"] = gan
    return c


def make_gan(c: dict, device: torch.device) -> SuperResVideoGAN:
    return SuperResVideoGAN(
        seq_length=c["seq_length"], temporal_context=c["temporal_context"],
        lr_height=c["lr_height"], lr_width=c["lr_width"],
        hr_height=c["hr_height"], hr_width=c["hr_width"],
        total_batch=c["total_batch"], **copy.deepcopy(c["gan_kwargs"]), device=device)


def generator_config(c: dict) -> dict:
    """The `.lvg` header of a G_ema checkpoint: kind and constructor kwargs."""
    return dict(kind="generator_sres",
                kwargs=dict(hr_height=c["hr_height"], hr_width=c["hr_width"],
                            lr_height=c["lr_height"], lr_width=c["lr_width"],
                            temporal_context=c["temporal_context"],
                            **c["gan_kwargs"]["G_kwargs"]))


def train_step(gan: SuperResVideoGAN, generator: torch.Generator, c: dict, step: int,
               batches: Iterator[dict]) -> list[dict]:
    """One training step on the reference schedule: G, D (the same lr batch
    conditions fake and real), R1 every `r1_interval` steps, ADA every
    `ada_interval`, then the G_ema update. `batches` yields dicts of
    `lr_video` [batch, 3, seq + 2 * context, lh, lw] and `hr_video` [batch,
    3, seq + 2 * context, hh, hw] tensors on the trainer's device. Returns
    the phases' statistics."""
    out = [gan.update_G(generator, next(batches)["lr_video"])]
    sample = next(batches)
    lr_video = sample["lr_video"]
    hr_video = gan.crop_to_seq_length(sample["hr_video"])
    out.append(gan.update_D(generator, lr_video, lr_video, hr_video))
    if c["r1_interval"] > 0 and step % c["r1_interval"] == 0:
        sample = next(batches)
        out.append(gan.update_r1(generator, gan.crop_to_seq_length(sample["lr_video"]),
                                 gan.crop_to_seq_length(sample["hr_video"]),
                                 gain=float(c["r1_interval"])))
    if c["ada_interval"] > 0 and step % c["ada_interval"] == 0:
        out.append(gan.update_ada(gain=float(c["ada_interval"])))
    gan.update_G_ema()
    return out


def _write_samples(c: dict, seed: int, device: torch.device,
                   samples_dir: Path) -> Callable[[torch.nn.Module, int, torch.Generator], None]:
    """Write `real-lr.mp4` and `real-hr.mp4`, a `result_seq_length`-frame
    pair of clips of the dataset; returns the writer of `fake-<step>-hr.mp4`,
    G_ema on that lr clip."""
    from .data.dataset import VideoDatasetTwoRes
    from .models.generator_sres import sample_video_segments
    from .utils.video import write_video_grid

    ctx = c["temporal_context"]
    real = VideoDatasetTwoRes(
        c["dataset_dir"], c["result_seq_length"] + 2 * ctx, c["lr_height"], c["lr_width"],
        c["hr_height"], c["hr_width"], x_flip=c["x_flip"]).sample(0, np.random.default_rng(seed))
    for res in ("lr", "hr"):
        write_video_grid(real[f"{res}_video"][None][:, :, ctx:-ctx or None],
                         samples_dir / f"real-{res}.mp4")
    real_lr = torch.from_numpy(real["lr_video"][None]).to(device)

    def write_fake(G_ema: torch.nn.Module, step: int, generator: torch.Generator) -> None:
        segments = sample_video_segments(G_ema, real_lr, segment_length=8, temporal_context=ctx,
                                         generator=generator)
        write_video_grid((s.cpu().numpy() for s in segments),
                         samples_dir / f"fake-{step:08d}-hr.mp4")

    return write_fake


def train(c: dict, run_dir: str, seed: int, device: torch.device,
          resume: Optional[str] = None) -> None:
    """`train.run.train` on the paired video dataset of `c` (`build_config`'s)."""
    from .data.dataset import VideoDatasetTwoRes

    print(f"Loading paired video dataset from {c['dataset_dir']} ...")
    dataset = VideoDatasetTwoRes(c["dataset_dir"], c["seq_length"] + 2 * c["temporal_context"],
                                 c["lr_height"], c["lr_width"], c["hr_height"], c["hr_width"],
                                 x_flip=c["x_flip"])
    run.train(c, run_dir, seed, device, resume, gan_name="super res", dataset=dataset,
              to_batch=lambda sample: {k: torch.from_numpy(sample[k]).to(device)
                                       for k in ("lr_video", "hr_video")},
              make_gan=make_gan, train_step=train_step, G_config=generator_config(c),
              write_samples=_write_samples,
              metric_kwargs=dict(
                  dataset_kwargs=dict(dataset_dir=c["dataset_dir"], seq_length=1,
                                      height=c["hr_height"], width=c["hr_width"]),
                  cond_dataset_kwargs=dict(dataset_dir=c["dataset_dir"], seq_length=1,
                                           height=c["lr_height"], width=c["lr_width"])))


def main(argv: Optional[list[str]] = None) -> str:
    """Parse the options, make the run directory, train; returns the run
    directory."""
    return run.main(
        argv, description="Train a super-resolution LongVideoGAN network with the PyTorch port.",
        outdir="runs/sres", batch=32, grad_accum=1,
        grad_accum_help="micro-batches per step of each process (default 1, as the reference). "
                        "The full preset at batch 32 needs 2 or more on one 80 GB H100: a "
                        "micro-batch of 32 runs out of memory.",
        config=lambda a: build_config(a.dataset_dir, a.total_batch, a.grad_accum, a.r1_gamma,
                                      a.preset, a.remat, a.block_remat),
        train=train)


if __name__ == "__main__":
    main()
