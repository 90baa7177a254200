"""Stage-1 (low-resolution) training: the port's trainer CLI.

Counterpart of the repository's `train_lres.py`: batch 64 of 128-frame 36x64
clips, G with `temporal_emb_dim=1024` and `temporal_padding=8`, D with
`channels_max=512`, DiffAugment `color,translation,cutout`, temporal scale
augment 1.0 and a random temporal translate of the fakes, R1 every 16 steps
with the lazy-regularization lr and beta2 correction; the `tiny` preset
shrinks everything for a CPU smoke run. Writes `config.json`, `stats.jsonl`
(one record per tick), a G_ema `.lvg` every `ticks_per_G_ema_ckpt` ticks and
a train `.lvg` every `ticks_per_train_ckpt`, which the JAX package reads as
its own (and `--resume` reads either's), and `samples/real-long.mp4` and
`samples/fake-<step>.mp4` (`result_seq_length` frames from G_ema). With
`--metric`, each G_ema checkpoint is scored too, into `metric-<name>.jsonl`.

    python -m long_video_gan_tpu_torch.train_lres --dataset datasets/horseback \\
        --outdir runs/lres --batch 64 --grad-accum 4 --gamma 1 --device cuda
    python -m long_video_gan_tpu_torch.train_lres --dataset data --preset tiny \\
        --batch 4 --device cpu
    python -m long_video_gan_tpu_torch.train_lres ... --resume ckpt-00000400-train.lvg
    python -m long_video_gan_tpu_torch.train_lres ... -m fvd2048_128f --metric-detector stub:64

Each step draws from a generator seeded from (seed, step), so a resumed run
draws at step s what an uninterrupted one draws there. Not ported: the JAX
CLI's XLA memory options (`--remat`, `--block-remat`, `--unroll-accum`),
`--wandb` and several processes.
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
from .train.gan_lres import LowResVideoGAN
from .train.stats import Collector, write_tick
from .utils.misc import cli_device


def build_config(dataset_dir: str, total_batch: int, grad_accum: int, r1_gamma: float,
                 preset: str, fp16_layers: int = 0, d_fp16_res: int = 0) -> dict:
    """The `full` and `tiny` presets of the repository's `train_lres.py`."""
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
        G_grad_accum=grad_accum, D_grad_accum=grad_accum,
        G_kwargs=dict(num_fp16_layers=fp16_layers, temporal_padding=8, temporal_emb_dim=1024),
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


def train(c: dict, run_dir: str, seed: int, device: torch.device,
          resume: Optional[str] = None) -> None:
    from .data.dataset import VideoDataset
    from .data.loader import get_infinite_data_iter
    from .io.checkpoint import save_generator
    from .models.generator_lres import sample_video_segments
    from .train.state import load_train_checkpoint, save_train_checkpoint
    from .utils.video import write_video_grid

    start_time = time.time()
    ckpt_dir = Path(run_dir, "checkpoints")
    samples_dir = Path(run_dir, "samples")
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    samples_dir.mkdir(parents=True, exist_ok=True)

    print(f"Loading video dataset from {c['dataset_dir']} ...")
    dataset = VideoDataset(c["dataset_dir"], c["seq_length"], c["height"], c["width"],
                           x_flip=c["x_flip"])
    result_dataset = VideoDataset(c["dataset_dir"], c["result_seq_length"], c["height"],
                                  c["width"], x_flip=c["x_flip"])
    data_iter = get_infinite_data_iter(dataset, batch_size=c["total_batch"], seed=seed,
                                       **c["loader_kwargs"])
    real = result_dataset.sample(0, np.random.default_rng(seed))["video"]
    write_video_grid(real[None], samples_dir / "real-long.mp4")

    print("Constructing low res GAN model ...")
    gan = make_gan(c, device)
    gan.init_state(torch.Generator().manual_seed(seed))
    start_step = 0
    if resume:
        start_step = int(load_train_checkpoint(resume, gan)["step"])
        print(f"Resumed from {resume} at step {start_step}")
    G_config = generator_config(c)

    batches = (torch.from_numpy(sample["video"]).to(device) for sample in data_iter)
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
                        gan.G_ema, 1, c["result_seq_length"],
                        generator=torch.Generator(device=device).manual_seed(seed + step))
                    write_video_grid((s.cpu().numpy() for s in segments),
                                     samples_dir / f"fake-{step:08d}.mp4")
                print(f"Wrote the checkpoints and samples of step {step}")
                if c.get("metrics"):
                    from .metrics.metric_main import report_metrics

                    report_metrics(
                        c["metrics"], run_dir, step, G=gan.G_ema, device=device,
                        detector=c.get("metric_detector"),
                        max_items_override=c.get("metric_items"),
                        dataset_kwargs=dict(dataset_dir=c["dataset_dir"], seq_length=1,
                                            height=c["height"], width=c["width"]))
            tick_start = time.time()

        if step == c["total_steps"]:
            print("Finished training!")
            break

        for stats in train_step(gan, step_generator(seed, step, device), c, step, batches):
            collector.report(stats)

    data_iter.close()
    stats_fp.close()


def set_matmul_precision(precision: str) -> None:
    """`--matmul-precision`: "highest" turns TF32 off for cuDNN convolutions
    and matmuls (the reference's f32), "high" allows it in matmuls too,
    "default" leaves PyTorch's flags as they are."""
    if precision == "highest":
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif precision == "high":
        torch.set_float32_matmul_precision("high")


def main(argv: Optional[list[str]] = None) -> str:
    """Parse the options, make the run directory, train; returns the run
    directory."""
    parser = argparse.ArgumentParser(description="Train a low-resolution LongVideoGAN "
                                                 "network with the PyTorch port.")
    parser.add_argument("--outdir", default="runs/lres")
    parser.add_argument("--dataset", dest="dataset_dir", required=True)
    parser.add_argument("--batch", dest="total_batch", type=int, default=64)
    parser.add_argument("--grad-accum", type=int, default=2,
                        help="micro-batches per step. Pass 4 for the full preset at batch 64 "
                             "in f32 on an 80 GB H100: the default 2 (the reference's) runs "
                             "out of memory there.")
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
    parser.add_argument("--fp16-layers", type=int, default=0,
                        help="run the last N generator layers in bfloat16")
    parser.add_argument("--d-fp16-res", type=int, default=0,
                        help="run the first N discriminator blocks in bfloat16")
    parser.add_argument("--matmul-precision", choices=["default", "high", "highest"],
                        default="default",
                        help="'highest' turns TF32 off: the reference's f32 convolutions")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = parser.parse_args(argv)
    device = cli_device(args.device)
    set_matmul_precision(args.matmul_precision)

    from .utils.video import get_next_run_dir

    c = build_config(args.dataset_dir, args.total_batch, args.grad_accum, args.r1_gamma,
                     args.preset, args.fp16_layers, args.d_fp16_res)
    if args.total_steps is not None:
        c["total_steps"] = args.total_steps
    c.update(metrics=args.metrics, metric_detector=args.metric_detector,
             metric_items=args.metric_items)
    c["matmul_precision"] = args.matmul_precision
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
