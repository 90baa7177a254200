"""Metric curve over a training run's G_ema checkpoints, computed after the run:
the PyTorch port's counterpart of `scripts/learning_curve.py`.

Point it at a run directory: it evaluates every saved `ckpt-*-G-ema.lvg`
(or every `--every`th, the last always) against the dataset with the FVD
protocol of the port's `metrics/metric_main` (`_compute_fvd`, as
in-training metrics run it), prints a step -> FVD table and appends one
JSON line per checkpoint to `<run_dir>/metric-curve.jsonl`.

`--detector stub:<dim>` runs without detector weights (a random projection:
still a distance between distributions, enough to see whether training
learns); `--detector i3d` with $LVG_DETECTOR_DIR holding the published file
runs the real protocol. Single-stage (lres) by default; `--sres <G_ema
checkpoint>` evaluates the two-stage pipeline, with the run's checkpoints as
its lres stage (then `--height/--width` are the hr dataset resolution).

    python3 scripts/torch_learning_curve.py --run-dir runs/00000-lres
    python3 scripts/torch_learning_curve.py --run-dir RUN --detector stub:16 --items 8 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from long_video_gan_tpu_torch.utils.misc import cli_device  # noqa: E402


def checkpoints(run: Path, every: int) -> list[Path]:
    """Every `every`th G_ema checkpoint of the run, and the last."""
    ckpts = sorted(run.glob("checkpoints/ckpt-*-G-ema.lvg"))
    if not ckpts:
        raise FileNotFoundError(f"no G_ema checkpoints under {run}/checkpoints")
    picked = ckpts[::every]
    return picked if ckpts[-1] in picked else picked + [ckpts[-1]]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run-dir", required=True,
                    help="training run dir (holds checkpoints/ and config.json)")
    ap.add_argument("--dataset", dest="dataset_dir", default=None,
                    help="dataset root (default: dataset_dir of the run's config.json)")
    ap.add_argument("--height", type=int, default=None,
                    help="real-stats resolution (default: from config.json)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--frames", dest="num_frames", type=int, default=16,
                    help="detector clip length (16 = the fvd2048_16f protocol)")
    ap.add_argument("--items", type=int, default=128,
                    help="real/generated feature count (2048 = the reference protocol)")
    ap.add_argument("--detector", default="stub:64",
                    help='detector spec: "i3d" (needs LVG_DETECTOR_DIR) or "stub:<dim>"')
    ap.add_argument("--every", type=int, default=1, help="evaluate every Nth checkpoint")
    ap.add_argument("--sres", dest="sres_path", default=None,
                    help="sres G_ema checkpoint for two-stage evaluation")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)

    from long_video_gan_tpu_torch.io.checkpoint import load_generator
    from long_video_gan_tpu_torch.metrics.metric_main import _compute_fvd
    from long_video_gan_tpu_torch.metrics.metric_utils import MetricOptions

    run = Path(args.run_dir)
    config = (json.loads((run / "config.json").read_text())
              if (run / "config.json").exists() else {})
    dataset_dir = args.dataset_dir or config.get("dataset_dir")
    if not dataset_dir:
        ap.error("--dataset required (the run's config.json has no dataset_dir)")
    height = args.height or config.get("height")
    width = args.width or config.get("width")

    ckpts = checkpoints(run, args.every)
    sres = load_generator(args.sres_path, device)[0] if args.sres_path else None
    curve_path = run / "metric-curve.jsonl"
    print(f"{len(ckpts)} checkpoints | detector={args.detector} frames={args.num_frames} "
          f"items={args.items} real={height}x{width}\n")
    print(f"{'step':>10}  fvd")
    out = []
    for ckpt in ckpts:
        step = int(re.search(r"ckpt-(\d+)-G-ema", ckpt.name).group(1))
        module, _ = load_generator(str(ckpt), device)
        G, lr_G = (module, None) if sres is None else (sres, module)
        opts = MetricOptions(G=G, lr_G=lr_G, detector=args.detector, seed=args.seed,
                             device=device,
                             dataset_kwargs=dict(dataset_dir=dataset_dir,
                                                 seq_length=args.num_frames,
                                                 height=height, width=width))
        fvd = _compute_fvd(opts, max_real=args.items, num_gen=args.items,
                           num_frames=args.num_frames)
        print(f"{step:>10}  {fvd:.4f}")
        record = dict(step=step, fvd=fvd, detector=args.detector, frames=args.num_frames,
                      items=args.items)
        with open(curve_path, "at") as fp:
            fp.write(json.dumps(record) + "\n")
        out.append(record)
    print(f"\ncurve -> {curve_path}")
    return out


if __name__ == "__main__":
    main()
