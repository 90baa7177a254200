"""The trainer CLIs' shared skeleton: their common options, the process
group, the run directory and its `config.json` (`main`), and the tick loop
(`train`). `train_lres` and `train_sres` pass in what is theirs: defaults,
extra options, the config, the dataset, the batch mapping, the sample writers
and the metric datasets.

A run directory holds `config.json`, `stats.jsonl` (one record per tick), a
G_ema `.lvg` every `ticks_per_G_ema_ckpt` ticks and a train `.lvg` every
`ticks_per_train_ckpt`, which the JAX package reads as its own (and
`--resume` reads either's), the stage's samples under `samples/`, and with
`--metric`, each G_ema checkpoint's score in `metric-<name>.jsonl`.

Each step draws from a generator seeded from (seed, step), so a resumed run
draws at step s what an uninterrupted one draws there. Several processes,
one per GPU, train one run over torch.distributed (NCCL; gloo on the CPU):
`--batch` is the global batch, split over them, and `--grad-accum` the
micro-batches per step of each; every process must pass the same `--seed`,
and only rank 0 writes.

    torchrun --nproc_per_node=8 -m long_video_gan_tpu_torch.train_lres \\
        --dataset datasets/horseback --batch 64 --grad-accum 1 --seed 1

`--matmul-precision highest` turns TF32 off in cuDNN convolutions and
matmuls, as its help says ("the reference's TF32-off f32"). `--remat`
recomputes each G and D micro-batch loss in the backward and
`--block-remat` each of G's blocks (`torch.utils.checkpoint`, the JAX flags'
counterparts); both trade time for memory.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Callable, Iterable, Optional

import torch

from ..data.jpeg import decoder_in_use
from ..parallel import mesh
from ..parallel.multihost import (is_main_process, local_device, maybe_initialize_distributed,
                                  world_size)
from ..utils.misc import add_remat_options, cli_device, set_matmul_precision
from .common import step_generator
from .stats import Collector, write_tick


def main(argv: Optional[list[str]], *, description: str, outdir: str, batch: int,
         grad_accum: int, grad_accum_help: str, config: Callable[[argparse.Namespace], dict],
         train: Callable, options: Iterable[tuple[str, dict]] = ()) -> str:
    """Parse the options (the shared ones with the stage's defaults, and the
    stage's `options`, (flag, `add_argument` kwargs) pairs), join the process
    group, make the run directory and its `config.json` from `config(args)`,
    and `train(c, run_dir, seed, device, resume)`; returns the run
    directory."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--outdir", default=outdir)
    parser.add_argument("--dataset", dest="dataset_dir", required=True)
    parser.add_argument("--batch", dest="total_batch", type=int, default=batch,
                        help="global batch, split over the processes")
    parser.add_argument("--grad-accum", type=int, default=grad_accum, help=grad_accum_help)
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
    parser.add_argument("--seed", type=int, default=None,
                        help="the run's seed (default 0); every process of a run needs the "
                             "same, so several processes must pass it")
    parser.add_argument("--resume", default=None,
                        help="train checkpoint (ckpt-*-train.lvg, the port's or the JAX "
                             "package's) to continue from, at the step in its header")
    parser.add_argument("--total-steps", type=int, default=None)
    for flag, kwargs in options:
        parser.add_argument(flag, **kwargs)
    parser.add_argument("--matmul-precision", choices=["default", "high", "highest"],
                        default="default",
                        help="'highest' turns TF32 off: the reference's f32 convolutions")
    add_remat_options(parser)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = parser.parse_args(argv)
    device = cli_device(args.device)
    # Several processes (env-gated; a single process without the launcher's
    # variables): parallel/multihost.py's docstring has the launch recipes.
    maybe_initialize_distributed(device)
    device = local_device(device)
    if args.seed is None:
        # Every process must use the same seed, so none can be drawn apart.
        assert world_size() == 1, "multi-host runs must pass --seed"
        args.seed = 0
    set_matmul_precision(args.matmul_precision)

    from ..utils.video import get_next_run_dir

    c = config(args)
    if args.total_steps is not None:
        c["total_steps"] = args.total_steps
    c.update(metrics=args.metrics, metric_detector=args.metric_detector,
             metric_items=args.metric_items)
    c["matmul_precision"] = args.matmul_precision
    desc = (f"{Path(args.dataset_dir).name}-{args.total_batch}batch-{args.grad_accum}accum-"
            f"{args.r1_gamma}gamma")
    # Rank 0 picks the run directory and tells the others: each process
    # counting the directories itself could count rank 0's new one.
    run_dir = mesh.broadcast_object(get_next_run_dir(args.outdir, desc=desc)
                                    if is_main_process() else None)
    if is_main_process():
        Path(run_dir).mkdir(parents=True, exist_ok=True)
        print(f"Run dir: {run_dir}  seed: {args.seed}  processes: {world_size()}")
        decoder = decoder_in_use()
        print(f"JPEG decoder: {decoder}")
        with open(Path(run_dir, "config.json"), "w") as fp:
            json.dump(dict(c, run_dir=run_dir, seed=args.seed, device=args.device,
                           resume=args.resume, processes=world_size(), jpeg_decoder=decoder),
                      fp, indent=2)
    train(c, run_dir, args.seed, device, args.resume)
    return run_dir


def train(c: dict, run_dir: str, seed: int, device: torch.device, resume: Optional[str], *,
          gan_name: str, dataset, to_batch: Callable[[dict], Any],
          make_gan: Callable, train_step: Callable, G_config: dict,
          write_samples: Callable, metric_kwargs: dict) -> None:
    """The tick loop of `c` (a stage's `build_config`) into `run_dir`.
    `dataset`'s samples become the stage's batches through `to_batch`;
    `make_gan(c, device)` builds the trainer and `train_step(gan, generator,
    c, step, batches)` steps it; `G_config` is the G_ema `.lvg` header.
    On rank 0, `write_samples(c, seed, device, samples_dir)` writes the real
    samples and returns `write_fake(G_ema, step, generator)`, called at each
    G_ema checkpoint, and `report_metrics` takes `metric_kwargs`."""
    from ..data.loader import get_infinite_data_iter
    from ..io.checkpoint import save_generator
    from .state import load_train_checkpoint, replicate_train_state, save_train_checkpoint

    start_time = time.time()
    main_process = is_main_process()
    ckpt_dir = Path(run_dir, "checkpoints")
    samples_dir = Path(run_dir, "samples")
    if main_process:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        samples_dir.mkdir(parents=True, exist_ok=True)

    data_iter = get_infinite_data_iter(dataset, seed=seed, **mesh.shard_batch(c["total_batch"]),
                                       **c["loader_kwargs"])
    write_fake = write_samples(c, seed, device, samples_dir) if main_process else None

    print(f"Constructing {gan_name} GAN model ...")
    gan = make_gan(c, device)
    gan.init_state(torch.Generator().manual_seed(seed))
    start_step = 0
    if resume:
        start_step = int(load_train_checkpoint(resume, gan)["step"])
        print(f"Resumed from {resume} at step {start_step}")
    replicate_train_state(gan)

    batches = (to_batch(sample) for sample in data_iter)
    collector = Collector()
    stats_fp = open(Path(run_dir, "stats.jsonl"), "at") if main_process else None
    tick_start = time.time()
    print(f"Training for steps {start_step:,} - {c['total_steps']:,}\n")
    for step in range(start_step, c["total_steps"] + 1):
        if step % c["steps_per_tick"] == 0:
            tick = step // c["steps_per_tick"]
            if step > start_step:
                write_tick(collector, stats_fp, step, tick, c["steps_per_tick"], tick_start,
                           start_time, device)
            if tick % c["ticks_per_G_ema_ckpt"] == 0 and main_process:
                save_generator(str(ckpt_dir / f"ckpt-{step:08d}-G-ema.lvg"), gan.G_ema, G_config)
                if tick % c["ticks_per_train_ckpt"] == 0:
                    save_train_checkpoint(str(ckpt_dir / f"ckpt-{step:08d}-train.lvg"), gan)
                with torch.no_grad():
                    write_fake(gan.G_ema, step,
                               torch.Generator(device=device).manual_seed(seed + step))
                print(f"Wrote the checkpoints and samples of step {step}")
                if c.get("metrics"):
                    from ..metrics.metric_main import report_metrics

                    report_metrics(c["metrics"], run_dir, step, G=gan.G_ema, device=device,
                                   detector=c.get("metric_detector"),
                                   max_items_override=c.get("metric_items"), **metric_kwargs)
            # The other processes wait here while rank 0 writes and scores.
            mesh.barrier()
            tick_start = time.time()

        if step == c["total_steps"]:
            print("Finished training!")
            break

        for stats in train_step(gan, step_generator(seed, step, device), c, step, batches):
            collector.report(stats)

    data_iter.close()
    if stats_fp is not None:
        stats_fp.close()
