"""Stage-2 (super-resolution) training: the port's trainer CLI.

Counterpart of the repository's `train_sres.py`: batch 32 of paired 36x64 /
144x256 clips of 4 (+ 2 x 4 context) frames, ADA every 4 steps, R1 every 16,
the full-strength ADA configuration; the `tiny` preset shrinks everything for
a CPU smoke run. The same lr batch conditions both the fake and the real
branch of the D step, as in the reference. Writes `config.json`,
`stats.jsonl` (one record per tick), a G_ema `.lvg` every
`ticks_per_G_ema_ckpt` ticks and a train `.lvg` every `ticks_per_train_ckpt`
(the JAX package reads both as its own, and `--resume` reads either's), and
`samples/real-lr.mp4`, `samples/real-hr.mp4` and `samples/fake-<step>-hr.mp4`
(G_ema on the real lr clip, in 8-frame segments with its temporal context).
With `--metric`, each G_ema checkpoint is scored too (G_ema on real lr clips
of the dataset, the cond-dataset protocol), into `metric-<name>.jsonl`.

    python -m long_video_gan_tpu_torch.train_sres --dataset datasets/horseback \\
        --outdir runs/sres --batch 32 --grad-accum 2 --device cuda
    python -m long_video_gan_tpu_torch.train_sres --dataset data --preset tiny \\
        --batch 4 --device cpu
    python -m long_video_gan_tpu_torch.train_sres ... --resume ckpt-00000400-train.lvg
    python -m long_video_gan_tpu_torch.train_sres ... -m fvd2048_16f --metric-detector stub:64

Data comes through the port's `data` package (ZIP shards of JPEG frames).
Each step draws from a generator seeded from (seed, step), so a resumed run
draws at step s what an uninterrupted one draws there. Several processes and
wandb are not ported yet.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from .train.common import step_generator
from .train.gan_sres import SuperResVideoGAN
from .train.stats import Collector, write_tick
from .utils.misc import cli_device


def build_config(dataset_dir: str, total_batch: int, grad_accum: int, r1_gamma: float,
                 preset: str) -> dict:
    """The `full` and `tiny` presets of the repository's `train_sres.py`."""
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
        G_grad_accum=grad_accum, D_grad_accum=grad_accum,
        G_kwargs=dict(num_fp16_res=4, fourfeats=False, resample_impl="auto"),
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


def train(c: dict, run_dir: str, seed: int, device: torch.device,
          resume: Optional[str] = None) -> None:
    from .data.dataset import VideoDatasetTwoRes
    from .data.loader import get_infinite_data_iter
    from .io.checkpoint import save_generator
    from .models.generator_sres import sample_video_segments
    from .train.state import load_train_checkpoint, save_train_checkpoint
    from .utils.video import write_video_grid

    start_time = time.time()
    ckpt_dir = Path(run_dir, "checkpoints")
    samples_dir = Path(run_dir, "samples")
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    samples_dir.mkdir(parents=True, exist_ok=True)

    ctx = c["temporal_context"]
    context_len = c["seq_length"] + 2 * ctx
    print(f"Loading paired video dataset from {c['dataset_dir']} ...")
    dataset = VideoDatasetTwoRes(c["dataset_dir"], context_len, c["lr_height"], c["lr_width"],
                                 c["hr_height"], c["hr_width"], x_flip=c["x_flip"])
    data_iter = get_infinite_data_iter(dataset, batch_size=c["total_batch"], seed=seed,
                                       **c["loader_kwargs"])
    result_dataset = VideoDatasetTwoRes(
        c["dataset_dir"], c["result_seq_length"] + 2 * ctx, c["lr_height"], c["lr_width"],
        c["hr_height"], c["hr_width"], x_flip=c["x_flip"])
    sample0 = result_dataset.sample(0, np.random.default_rng(seed))
    result_lr = torch.from_numpy(sample0["lr_video"][None]).to(device)
    write_video_grid(sample0["lr_video"][None][:, :, ctx:-ctx or None],
                     samples_dir / "real-lr.mp4")
    write_video_grid(sample0["hr_video"][None][:, :, ctx:-ctx or None],
                     samples_dir / "real-hr.mp4")

    print("Constructing super res GAN model ...")
    gan = make_gan(c, device)
    gan.init_state(torch.Generator().manual_seed(seed))
    start_step = 0
    if resume:
        start_step = int(load_train_checkpoint(resume, gan)["step"])
        print(f"Resumed from {resume} at step {start_step}")
    G_config = generator_config(c)

    batches = ({k: torch.from_numpy(v).to(device) for k, v in sample.items()
                if k in ("lr_video", "hr_video")} for sample in data_iter)
    collector = Collector()
    stats_fp = open(Path(run_dir, "stats.jsonl"), "at")
    tick_start = time.time()
    print(f"Training for steps {start_step:,} - {c['total_steps']:,}\n")
    for step in range(start_step, c["total_steps"] + 1):
        if step % c["steps_per_tick"] == 0:
            tick = step // c["steps_per_tick"]
            if step > start_step:
                write_tick(collector, stats_fp, step, tick, c["steps_per_tick"], tick_start,
                           start_time, device)
            if tick % c["ticks_per_G_ema_ckpt"] == 0:
                save_generator(str(ckpt_dir / f"ckpt-{step:08d}-G-ema.lvg"), gan.G_ema, G_config)
                if tick % c["ticks_per_train_ckpt"] == 0:
                    save_train_checkpoint(str(ckpt_dir / f"ckpt-{step:08d}-train.lvg"), gan)
                with torch.no_grad():
                    segments = sample_video_segments(
                        gan.G_ema, result_lr, segment_length=8, temporal_context=ctx,
                        generator=torch.Generator(device=device).manual_seed(seed + step))
                    write_video_grid((s.cpu().numpy() for s in segments),
                                     samples_dir / f"fake-{step:08d}-hr.mp4")
                print(f"Wrote the checkpoints and samples of step {step}")
                if c.get("metrics"):
                    # The sres G on real lr clips: the cond-dataset protocol.
                    from .metrics.metric_main import report_metrics

                    report_metrics(
                        c["metrics"], run_dir, step, G=gan.G_ema, device=device,
                        detector=c.get("metric_detector"),
                        max_items_override=c.get("metric_items"),
                        dataset_kwargs=dict(dataset_dir=c["dataset_dir"], seq_length=1,
                                            height=c["hr_height"], width=c["hr_width"]),
                        cond_dataset_kwargs=dict(dataset_dir=c["dataset_dir"], seq_length=1,
                                                 height=c["lr_height"], width=c["lr_width"]))
            tick_start = time.time()

        if step == c["total_steps"]:
            print("Finished training!")
            break

        for stats in train_step(gan, step_generator(seed, step, device), c, step, batches):
            collector.report(stats)

    data_iter.close()
    stats_fp.close()


def main(argv: Optional[list[str]] = None) -> str:
    """Parse the options, make the run directory, train; returns the run
    directory."""
    parser = argparse.ArgumentParser(description="Train a super-resolution LongVideoGAN "
                                                 "network with the PyTorch port.")
    parser.add_argument("--outdir", default="runs/sres")
    parser.add_argument("--dataset", dest="dataset_dir", required=True)
    parser.add_argument("--batch", dest="total_batch", type=int, default=32)
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="micro-batches per step (default 1, as the reference). The full "
                             "preset at batch 32 needs 2 or more on an 80 GB H100: a "
                             "micro-batch of 32 runs out of memory.")
    parser.add_argument("--gamma", dest="r1_gamma", type=float, default=1.0)
    parser.add_argument("--metric", "-m", dest="metrics", action="append", default=[],
                        help="metric to compute at every G_ema checkpoint (repeatable), "
                             "appended to metric-<name>.jsonl")
    parser.add_argument("--metric-detector", default=None,
                        help='detector override for in-training metrics, e.g. "stub:64" '
                             "for detector-less smoke runs (default: the real detector "
                             "files, see metrics/detectors.py)")
    parser.add_argument("--metric-items", type=int, default=None,
                        help="cap real/generated feature counts of in-training metrics "
                             "(smoke runs; default: each metric's full protocol)")
    parser.add_argument("--preset", choices=["full", "tiny"], default="full")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume", default=None,
                        help="train checkpoint (ckpt-*-train.lvg, the port's or the JAX "
                             "package's) to continue from, at the step in its header")
    parser.add_argument("--total-steps", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = parser.parse_args(argv)
    device = cli_device(args.device)

    from .utils.video import get_next_run_dir

    c = build_config(args.dataset_dir, args.total_batch, args.grad_accum, args.r1_gamma,
                     args.preset)
    if args.total_steps is not None:
        c["total_steps"] = args.total_steps
    c.update(metrics=args.metrics, metric_detector=args.metric_detector,
             metric_items=args.metric_items)
    desc = (f"{Path(args.dataset_dir).name}-{args.total_batch}batch-{args.grad_accum}accum-"
            f"{args.r1_gamma}gamma")
    run_dir = get_next_run_dir(args.outdir, desc=desc)
    Path(run_dir).mkdir(parents=True, exist_ok=True)
    print(f"Run dir: {run_dir}  seed: {args.seed}")
    with open(Path(run_dir, "config.json"), "w") as fp:
        json.dump(dict(c, run_dir=run_dir, seed=args.seed, device=args.device,
                       resume=args.resume), fp, indent=2)
    train(c, run_dir, args.seed, device, args.resume)
    return run_dir


if __name__ == "__main__":
    main()
