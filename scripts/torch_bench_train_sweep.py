"""Sweep of `long_video_gan_tpu_torch.bench_train` on one NVIDIA GPU: which
grad-accum and bf16 ladders give the fastest training step that fits.

Runs `bench_lres` for every grad-accum of LRES_ACCUMS x LRES_FP16_LAYERS
(the lres G's bf16 tail) x LRES_D_FP16_RES (the lres D's bf16 head), and
`bench_sres` for every grad-accum of SRES_ACCUMS, in one process, each
with STEPS timed steps after bench_train's two warm-up cycles. Prints the
card, one JSON line per configuration (bench_train's, or {"oom": true}
where it ran out of device memory), and then the fastest configuration
that fitted of each kind.
Exits 1 if a configuration failed otherwise (a non-finite loss, an error).

    python3 scripts/torch_bench_train_sweep.py
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import sys
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from long_video_gan_tpu_torch import bench_train  # noqa: E402
from long_video_gan_tpu_torch.utils.profiling import gpu_name_and_power_limit  # noqa: E402


# The grid: the grad-accums down to micro-batches of 8 clips, each lres one
# with and without the bf16 tail of the G (its last 6 layers) and head of
# the D (its first 2 blocks): the JAX script's ladder values.
LRES_ACCUMS = (1, 2, 4, 8)
LRES_FP16_LAYERS = (0, 6)
LRES_D_FP16_RES = (0, 2)
SRES_ACCUMS = (1, 2, 4)
STEPS = 4          # R1 runs at step 0: the median is of steps without it


def run(fn, **config) -> dict:
    """bench_train's record of one configuration, or that it ran out of
    memory or failed."""
    try:
        return fn(**config)
    except torch.cuda.OutOfMemoryError as e:
        return {**config, "oom": True, "error": str(e).splitlines()[0][:200]}
    except Exception as e:   # the sweep goes on; the exit code reports it
        traceback.print_exc()
        return {**config, "failed": True, "error": f"{type(e).__name__}: {e}"[:300]}
    finally:
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bench_train_sweep: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    print(gpu_name_and_power_limit())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    records = {"lres": [], "sres": []}
    for accum, layers, d_res in itertools.product(LRES_ACCUMS, LRES_FP16_LAYERS,
                                                  LRES_D_FP16_RES):
        records["lres"].append(run(bench_train.bench_lres, accum=accum, steps=STEPS,
                                   fp16_layers=layers, d_fp16_res=d_res))
        print(json.dumps(records["lres"][-1]), flush=True)
    for accum in SRES_ACCUMS:
        records["sres"].append(run(bench_train.bench_sres, accum=accum, steps=STEPS))
        print(json.dumps(records["sres"][-1]), flush=True)
    for kind, recs in records.items():
        fitted = [r for r in recs if "value" in r]
        if fitted:
            print(json.dumps({"fastest": kind, **min(fitted, key=lambda r: r["value"])}))
    return 1 if any(r.get("failed") for recs in records.values() for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
