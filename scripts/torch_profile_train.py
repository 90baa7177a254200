"""Per-phase breakdown of the PyTorch port's sres or lres training step on one
NVIDIA GPU, and optionally a `torch.profiler` trace of it.

`long_video_gan_tpu_torch.bench_train` gives one sec/step for the whole
cycle. This script times each phase of the same configuration apart
(`update_G`, `update_D`, `update_r1`, `update_ada` for sres, `update_G_ema`;
one warm-up call, then the mean of `--steps` calls, each ended by
`torch.cuda.synchronize()`), weights each by its cadence in the cycle (G 1,
D 1, R1 1/16, ADA 1/4, G_ema 1) and prints per phase `sec`,
`amortized_sec` and `pct_of_step`, then the amortized sec/step.

With `--trace DIR` it traces one full cycle (or the phase `--trace-phase`
names) through `utils/profiling.trace`, prints the device time by kernel
category and the top kernels (`print_op_summary`), and the traced wall
seconds beside the device total.

    python3 scripts/torch_profile_train.py --config sres --trace /tmp/lvg_trace
    python3 scripts/torch_profile_train.py --config lres --trace /tmp/lvg_trace \\
        --trace-phase update_D
    python3 scripts/torch_profile_train.py --config sres --preset tiny --device cpu

`--preset tiny` runs the trainers' tiny presets (a CPU check of the
script; the CPU's times say nothing of the card's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from long_video_gan_tpu_torch import bench_train  # noqa: E402
from long_video_gan_tpu_torch.utils import profiling  # noqa: E402
from long_video_gan_tpu_torch.utils.misc import cli_device  # noqa: E402


def step_shares(rows: list[dict]) -> float:
    """Fill each phase row's `weight`-amortized `amortized_sec` and its
    `pct_of_step`; returns the amortized sec/step."""
    for r in rows:
        r["amortized_sec"] = r["sec"] * r["weight"]
    total = sum(r["amortized_sec"] for r in rows)
    for r in rows:
        r["pct_of_step"] = 100 * r["amortized_sec"] / total
    return total


def time_phases(bench: bench_train.Bench, steps: int) -> tuple[list[dict], float]:
    """Each phase once to warm up, then the mean seconds of `steps` calls;
    returns (rows of phase, sec, weight, amortized_sec, pct_of_step, the
    amortized sec/step)."""
    generator = torch.Generator(device=bench.device).manual_seed(1)
    rows = []
    for name, fn, every in bench.phases:
        fn(generator)
        bench_train.synchronize(bench.device)
        start = time.perf_counter()
        for _ in range(steps):
            fn(generator)
            bench_train.synchronize(bench.device)
        rows.append({"phase": name, "sec": (time.perf_counter() - start) / steps,
                     "weight": 1 / every})
    return rows, step_shares(rows)


def trace_cycle(bench: bench_train.Bench, trace_dir: str, phase=None, top: int = 30) -> dict:
    """One call of each phase (or of `phase` alone) under the profiler; prints
    the op summary and returns {phases, wall_sec, device_sec, categories:
    {category: (seconds, launches)}}."""
    traced = [(name, fn) for name, fn, _ in bench.phases if phase in (None, name)]
    if not traced:
        raise ValueError(f"no phase named {phase!r}")
    generator = torch.Generator(device=bench.device).manual_seed(2)
    bench_train.synchronize(bench.device)
    with profiling.trace(trace_dir):
        start = time.perf_counter()
        for _, fn in traced:
            fn(generator)
        bench_train.synchronize(bench.device)
        wall = time.perf_counter() - start
    rows = profiling.trace_op_times(trace_dir)
    categories = profiling.print_op_summary(rows, top=top)
    out = {"trace_dir": trace_dir, "phases": [n for n, _ in traced], "wall_sec": wall,
           "device_sec": sum(d for _, d in rows)}
    print(json.dumps(out), flush=True)
    return {**out, "categories": categories}


def build(config: str, accum, fp16_layers: int, d_fp16_res: int, preset: str,
          device) -> bench_train.Bench:
    if config == "sres":
        return bench_train.make_sres_bench(accum or bench_train.DEFAULT_SRES_ACCUM, preset, device)
    return bench_train.make_lres_bench(accum or bench_train.DEFAULT_LRES_ACCUM, fp16_layers,
                                       d_fp16_res, preset, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=["sres", "lres"], default="sres")
    ap.add_argument("--accum", type=int, default=None,
                    help="grad-accum (default: bench_train's for the config)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lres-fp16-layers", type=int, default=bench_train.DEFAULT_LRES_FP16_LAYERS)
    ap.add_argument("--lres-d-fp16-res", type=int, default=bench_train.DEFAULT_LRES_D_FP16_RES)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of one cycle here and print its op summary")
    ap.add_argument("--trace-phase", default=None, help="trace only this phase")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--preset", choices=["full", "tiny"], default="full")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    print(profiling.gpu_name_and_power_limit(device) or "cpu")
    bench = build(args.config, args.accum, args.lres_fp16_layers, args.lres_d_fp16_res,
                  args.preset, device)
    rows, total = time_phases(bench, args.steps)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"config": args.config, **bench.record,
                      "amortized_sec_per_step": total}), flush=True)
    if args.trace:
        trace_cycle(bench, args.trace, args.trace_phase, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
