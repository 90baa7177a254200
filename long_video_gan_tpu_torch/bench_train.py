"""Training-throughput benchmark of the port on one NVIDIA GPU.

Counterpart of the repository's `bench_train.py`: seconds per step and peak
device memory of the reference's two headline training configurations, on
seeded synthetic data made on the device (the data path is not timed):

  * lres: total batch 64 in `--lres-accum` micro-batches, 128 frames at
    36x64, the `train_lres` full preset (random temporal translate,
    temporal scale augment 1.0, R1 gamma 1, G `temporal_padding=8`,
    `temporal_emb_dim=1024`), the G and D bf16 ladders from
    `--lres-fp16-layers` / `--lres-d-fp16-res`;
  * sres: total batch 32 in `--sres-accum` micro-batches, 4 (+ 2 x 4
    context) frames, 36x64 -> 144x256, the `train_sres` full preset
    (`num_fp16_res=4`, `resample_impl="auto"`: K1 and K2 run on it).

One step is the reference cycle: `update_G`, `update_D`, then `update_r1`
when `i % 16 == 0`, `update_ada` when `i % 4 == 0` (sres), then
`update_G_ema`; two warm-up cycles (both with R1, and ADA) come first, and
`torch.cuda.synchronize()` ends every timed step. The value is the median
over `--steps`. Prints one JSON line per configuration, with the card's name
and power limit.

    python -m long_video_gan_tpu_torch.bench_train --config both
    python -m long_video_gan_tpu_torch.bench_train --config lres --lres-accum 2 \\
        --lres-fp16-layers 6 --lres-d-fp16-res 2 --steps 4

The defaults are the fastest configuration that fitted in a sweep on an
NVIDIA H100 80GB HBM3 at 700 W (`scripts/torch_bench_train_sweep.py`).
Not ported: the JAX script's XLA knobs (`--remat`, `--block-remat`,
`--unroll-accum`).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from .train.common import step_generator
from .utils.misc import cli_device
from .utils.profiling import gpu_name_and_power_limit

LRES_METRIC = "lres_train_sec_per_step_batch64_seq128"
SRES_METRIC = "sres_train_sec_per_step_batch32_144x256"
# Total batch per configuration and preset: the reference's at "full", a
# CPU-sized one at the trainers' "tiny" preset.
BATCH = {"lres": {"full": 64, "tiny": 4}, "sres": {"full": 32, "tiny": 4}}
R1_EVERY, ADA_EVERY = 16, 4    # bench_train.py's cadence (r1_interval, ADA interval)
WARMUP_SEEDS = (1, 11)         # two warm-up cycles, each with R1 (and ADA)
SEED = 0

# The sweep's fastest configurations that fit (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md): lres grad-accum 4 with the G's last 6 layers and the D's first
# 2 blocks in bf16 (4.235 s, 36.97 GiB; 1 and 2 run out of memory at every
# ladder), sres grad-accum 2 (2.056 s, 39.18 GiB; 1 runs out).
DEFAULT_LRES_ACCUM = 4
DEFAULT_LRES_FP16_LAYERS = 6
DEFAULT_LRES_D_FP16_RES = 2
DEFAULT_SRES_ACCUM = 2


@dataclass
class Bench:
    """A trainer at one configuration with its synthetic data: `phases` are
    (name, fn(generator), every): the phase runs at steps i % every == 0."""
    gan: Any
    phases: list[tuple[str, Callable[[torch.Generator], Any], int]]
    record: dict          # the configuration's fields of the JSON line
    device: torch.device


def make_lres_bench(accum: int, fp16_layers: int = 0, d_fp16_res: int = 0,
                    preset: str = "full", device="cuda") -> Bench:
    """The lres configuration: `train_lres`'s preset with total batch
    BATCH["lres"][preset] in `accum` micro-batches, weights and one real
    batch of N(0, 1) videos from SEED."""
    from .train_lres import build_config, make_gan

    device = torch.device(device)
    c = build_config("", BATCH["lres"][preset], accum, 1.0, preset, fp16_layers, d_fp16_res)
    gan = make_gan(c, device)
    gan.init_state(torch.Generator().manual_seed(SEED))
    data_gen = torch.Generator(device=device).manual_seed(SEED + 1)
    real = torch.randn((c["total_batch"], 3, c["seq_length"], c["height"], c["width"]),
                       generator=data_gen, device=device)
    phases = [("update_G", lambda g: gan.update_G(g), 1),
              ("update_D", lambda g: gan.update_D(g, real), 1),
              ("update_r1", lambda g: gan.update_r1(g, real, gain=float(R1_EVERY)), R1_EVERY),
              ("update_G_ema", lambda g: gan.update_G_ema(), 1)]
    return Bench(gan, phases, dict(metric=LRES_METRIC, grad_accum=accum,
                                   fp16_layers=fp16_layers, d_fp16_res=d_fp16_res), device)


def make_sres_bench(accum: int, preset: str = "full", device="cuda") -> Bench:
    """The sres configuration: `train_sres`'s preset with total batch
    BATCH["sres"][preset] in `accum` micro-batches, weights and one batch
    of N(0, 1) lr (with context) and hr clips from SEED."""
    from .train_sres import build_config, make_gan

    device = torch.device(device)
    c = build_config("", BATCH["sres"][preset], accum, 1.0, preset)
    gan = make_gan(c, device)
    gan.init_state(torch.Generator().manual_seed(SEED))
    data_gen = torch.Generator(device=device).manual_seed(SEED + 1)
    n = c["total_batch"]
    lr_ctx = torch.randn((n, 3, c["seq_length"] + 2 * c["temporal_context"], c["lr_height"],
                          c["lr_width"]), generator=data_gen, device=device)
    lr = gan.crop_to_seq_length(lr_ctx)
    hr = torch.randn((n, 3, c["seq_length"], c["hr_height"], c["hr_width"]),
                     generator=data_gen, device=device)
    phases = [("update_G", lambda g: gan.update_G(g, lr_ctx), 1),
              ("update_D", lambda g: gan.update_D(g, lr_ctx, lr_ctx, hr), 1),
              ("update_r1", lambda g: gan.update_r1(g, lr, hr, gain=float(R1_EVERY)), R1_EVERY),
              ("update_ada", lambda g: gan.update_ada(gain=float(ADA_EVERY)), ADA_EVERY),
              ("update_G_ema", lambda g: gan.update_G_ema(), 1)]
    return Bench(gan, phases, dict(metric=SRES_METRIC, grad_accum=accum), device)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cycle(bench: Bench, i: int, generator: torch.Generator) -> dict:
    """One step of the cycle at index `i`: the phases due there, in order.
    Returns {phase: its statistics}."""
    return {name: fn(generator) for name, fn, every in bench.phases if i % every == 0}


def check_finite(stats: dict) -> None:
    """Raise if a loss statistic of a cycle is not finite."""
    bad = [f"{phase}/{k}" for phase, s in stats.items() for k, v in (s or {}).items()
           if k.startswith("loss/") and not bool(torch.isfinite(v).all())]
    if bad:
        raise FloatingPointError(f"non-finite training statistics: {bad}")


def measure(bench: Bench, steps: int) -> dict:
    """The JSON record of `steps` timed steps after two warm-up cycles:
    median and mean seconds per step, each step's seconds, the peak device
    memory (GiB, None on the CPU) and the card. Raises if a loss of the last
    step is not finite."""
    device = bench.device
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for seed in WARMUP_SEEDS:
        run_cycle(bench, 0, torch.Generator(device=device).manual_seed(seed))
        synchronize(device)
    per_step = []
    stats = {}
    for i in range(steps):
        generator = step_generator(SEED + 2, i, device)
        start = time.perf_counter()
        stats = run_cycle(bench, i, generator)
        synchronize(device)
        per_step.append(time.perf_counter() - start)
    check_finite(stats)
    card = gpu_name_and_power_limit(device)
    name, power = card.rsplit(", ", 1) if card else (device.type, None)
    peak = (round(torch.cuda.max_memory_allocated(device) / 2**30, 2)
            if device.type == "cuda" else None)
    return {"metric": bench.record["metric"],
            "value": round(statistics.median(per_step), 4),
            "unit": "sec/step",
            "mean": round(statistics.fmean(per_step), 4),
            "per_step": [round(t, 4) for t in per_step],
            **{k: v for k, v in bench.record.items() if k != "metric"},
            "peak_hbm_gb": peak,
            "device": name,
            "power_limit": power}


def bench_lres(accum: int, steps: int, fp16_layers: int = 0, d_fp16_res: int = 0,
               preset: str = "full", device="cuda") -> dict:
    return measure(make_lres_bench(accum, fp16_layers, d_fp16_res, preset, device), steps)


def bench_sres(accum: int, steps: int, preset: str = "full", device="cuda") -> dict:
    return measure(make_sres_bench(accum, preset, device), steps)


def main(argv: Optional[list[str]] = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=["lres", "sres", "both"], default="both")
    ap.add_argument("--lres-accum", type=int, default=DEFAULT_LRES_ACCUM)
    ap.add_argument("--sres-accum", type=int, default=DEFAULT_SRES_ACCUM)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lres-fp16-layers", type=int, default=DEFAULT_LRES_FP16_LAYERS,
                    help="run the last N lres generator layers in bf16")
    ap.add_argument("--lres-d-fp16-res", type=int, default=DEFAULT_LRES_D_FP16_RES,
                    help="run the first N lres discriminator blocks in bf16")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    out = []
    if args.config in ("lres", "both"):
        out.append(bench_lres(args.lres_accum, args.steps, args.lres_fp16_layers,
                              args.lres_d_fp16_res, device=device))
        print(json.dumps(out[-1]), flush=True)
    if args.config in ("sres", "both"):
        out.append(bench_sres(args.sres_accum, args.steps, device=device))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()
