"""Tiny versions of the benchmark's cells for CPU tests: the sres trainer's
tiny preset and a short stream, with the cells' own limits; and a run of a
cell at its own size on the card."""

from __future__ import annotations

import copy
import math
import time

import torch

from h100_bench import run as bench_run
from h100_bench.common import Run

SEED = 2 ** 33 + 5

TINY_SRES_G = dict(hr_height=32, hr_width=64, lr_height=8, lr_width=16, temporal_context=2,
                   latent_z_dim=32, latent_w_dim=32, margin_size=4, num_fp16_res=2,
                   channel_base=1024, channel_max=32, num_layers=6)


def tiny_cell(name: str, num_fp16_res: int = 2) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of cell `name` at a CPU size."""
    cell, config, traffic = bench_run.load_cell(name)
    if traffic["driver"] == "stream":
        model = dict(TINY_SRES_G, num_fp16_res=num_fp16_res)
        config = dict(config, model=model)
        traffic = dict(traffic, frames_per_video=32, segment_length=8, lr_videos=2, z_table=8,
                       trace_segments=4)
        return cell, config, traffic
    from long_video_gan_tpu_torch.train_sres import build_config

    c = build_config("", 4, 2, 1.0, "tiny")
    gan = copy.deepcopy(c["gan_kwargs"])
    gan["G_kwargs"].pop("block_remat")
    gan.pop("remat")
    keys = ("seq_length", "temporal_context", "lr_height", "lr_width", "hr_height", "hr_width")
    gan.update({k: c[k] for k in keys}, total_batch=4)
    gan["G_kwargs"]["num_fp16_res"] = gan["D_kwargs"]["num_fp16_res"] = num_fp16_res
    cadence = {k: 2 for k in config["cadence"]}
    return cell, dict(config, gan=gan, cadence=cadence), traffic


def run_tiny(name: str, seconds: float | None = None, control: bool = False, alter=None,
             num_fp16_res: int = 2) -> dict:
    """One run of cell `name` at its CPU size, past the look for a chip
    (a 2-s window for the stream, whose check needs a sampled segment; one
    cycle for training)."""
    torch.manual_seed(0)
    cell, config, traffic = tiny_cell(name, num_fp16_res)
    if seconds is None:
        seconds = 2.0 if traffic["driver"] == "stream" else 0.1
    e2e, per_layer = bench_run.benchmark_entries(name)
    run = Run(cell=cell, config=config, traffic=traffic, seed=SEED, seconds=seconds,
              trace=False, device=torch.device("cpu"), control=control)
    if alter is not None:
        run.alter = alter
    return bench_run.run_cell(run, e2e, per_layer, time.time())


# Every number the training check reads, compared or not.
TRAIN_NUMBERS = [f"{kind}.{phase}" for kind in ("loss_rel", "loss0_rel", "grad_norm_rel",
                                                "grad_norm_med") for phase in ("G", "D", "r1")
                 ] + [f"change_norm_rel.{module}" for module in ("G", "D", "G_ema")]


def run_full(name: str, seed: int, seconds: float = 5.0, control: bool = False) -> dict:
    """One run of cell `name` at its own size on the card, in this process
    (so that a test can plant a fault underneath), past the look for a
    chip. Its `checked` holds every number the check read: those without a
    limit in the cell at an infinite one."""
    cell, config, traffic = bench_run.load_cell(name)
    if traffic["driver"] == "train":
        cell = dict(cell, limits={**dict.fromkeys(TRAIN_NUMBERS, math.inf), **cell["limits"]})
    e2e, per_layer = bench_run.benchmark_entries(name)
    run = Run(cell=cell, config=config, traffic=traffic, seed=seed, seconds=seconds,
              trace=False, device=torch.device("cuda", 0), control=control)
    return bench_run.run_cell(run, e2e, per_layer, time.time())
