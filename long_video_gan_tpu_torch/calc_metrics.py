"""Quality metrics of trained checkpoints: the port's metric CLI.

Counterpart of the repository's `calc_metrics.py`: evaluates the two-stage
lres -> sres pipeline (or a single lres generator) against a dataset,
averaging over `--num-runs` with fresh seeds, and prints one JSON line per
metric, appended to `--output` too.

    python -m long_video_gan_tpu_torch.calc_metrics --metric fvd2048_16f \\
        --lres lres.lvg --sres sres.lvg --dataset datasets/horseback
    python -m long_video_gan_tpu_torch.calc_metrics -m fid50k_full --lres lres.lvg \\
        --dataset data --detector stub:64 --max-items 64 --device cpu

Detectors: no file ships with the repository. Put the published files
(URLs in `metrics/detectors.py`) in one directory and point
$LVG_DETECTOR_DIR at it, or pass `--detector <family>:<path>`; `stub:<dim>`
runs the pipeline without one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

from .utils.misc import cli_device


def main(argv: Optional[list[str]] = None) -> list[dict]:
    """Parse the options and compute each metric; returns the results."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--metric", "-m", dest="metrics", action="append", required=True,
                    help="metric to compute (repeatable), e.g. fvd2048_128f, fid50k_full")
    ap.add_argument("--sres", dest="sres_path", default=None, help="sres G_ema checkpoint")
    ap.add_argument("--lres", dest="lres_path", required=True, help="lres G_ema checkpoint")
    ap.add_argument("--dataset", dest="dataset_dir", required=True)
    ap.add_argument("--num-runs", type=int, default=1)
    ap.add_argument("--batch", dest="batch_size", type=int, default=16)
    ap.add_argument("--detector", default=None,
                    help="detector override: <family>:<path>, a torchscript path or "
                         "stub:<dim> (tests)")
    ap.add_argument("--max-items", type=int, default=None,
                    help="cap real/generated feature counts (validation/smoke runs)")
    ap.add_argument("--output", default=None, help="JSONL output path")
    ap.add_argument("--replace-cache", action="store_true",
                    help="recompute the dataset feature stats instead of reusing the "
                         "blake2b-keyed cache (reference calc_metrics.py:29)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    from .data.jpeg import decoder_in_use
    from .io.checkpoint import load_generator
    from .metrics import metric_main

    # stderr: stdout carries one JSON line per metric.
    print(f"JPEG decoder: {decoder_in_use()}", file=sys.stderr)

    lres_G, _ = load_generator(args.lres_path, device)
    kwargs = dict(num_runs=args.num_runs, batch_size=args.batch_size, seed=args.seed,
                  verbose=args.verbose, detector=args.detector,
                  max_items_override=args.max_items, replace_cache=args.replace_cache,
                  device=device)
    if args.sres_path is not None:
        sres_G, _ = load_generator(args.sres_path, device)
        kwargs.update(
            G=sres_G, lr_G=lres_G,
            dataset_kwargs=dict(dataset_dir=args.dataset_dir, seq_length=1,
                                height=sres_G.hr_height, width=sres_G.hr_width),
            cond_dataset_kwargs=dict(dataset_dir=args.dataset_dir, seq_length=1,
                                     height=sres_G.lr_height, width=sres_G.lr_width))
    else:
        kwargs.update(
            G=lres_G,
            dataset_kwargs=dict(dataset_dir=args.dataset_dir, seq_length=1,
                                height=lres_G.out_height, width=lres_G.out_width))

    results = []
    for metric in args.metrics:
        result = metric_main.calc_metric(metric=metric, **kwargs)
        line = json.dumps(dict(result, lres=args.lres_path, sres=args.sres_path))
        print(line)
        if args.output:
            Path(args.output).parent.mkdir(parents=True, exist_ok=True)
            with open(args.output, "at") as fp:
                fp.write(line + "\n")
        results.append(result)
    return results


if __name__ == "__main__":
    main()
