"""The `lres-train` cell at the lres trainer's tiny preset, for CPU tests:
its own driver and limits, the configuration as `train_lres.build_config`
gives it at that size."""

from __future__ import annotations

import torch

from h100_bench import run as bench_run
from h100_bench.common import Run
from h100_bench.drivers import train_lres

SEED = 2 ** 33 + 7


def tiny_run(control: bool = False, seconds: float = 0.1, checked_steps: int = 3) -> Run:
    """A run of `lres-train` at the tiny preset (batch 4 in 2 micro-batches
    of 8-frame 8x16 clips, R1 every 2 cycles) on the CPU."""
    cell, config, traffic = bench_run.load_cell("lres-train")
    config = dict(config, preset="tiny", total_batch=4, grad_accum=2)
    c = train_lres.cli_config(config)
    config.update(gan=train_lres.gan_kwargs(c), cadence={"r1_interval": c["r1_interval"]})
    traffic = dict(traffic, checked_steps=checked_steps, pool_batches=3)
    return Run(cell=cell, config=config, traffic=traffic, seed=SEED, seconds=seconds,
               trace=False, device=torch.device("cpu"), control=control)
