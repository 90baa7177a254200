"""Which grad-accum the PyTorch port's full-preset lres training fits at on one
NVIDIA GPU: 64 clips of 128 frames at 36x64 per step, `train_lres.py`'s full
preset (f32 unless `--fp16-layers` / `--d-fp16-res` ask for the bf16 layers),
seeded random weights and synthetic videos made on the card, driven through
`train_lres.train_step` by `chip_smoke.lres_train_steps`.

For each grad-accum in `--accums`, smallest first, it runs `--steps` steps
(step 0 runs R1) and prints each step's seconds per phase and the peak
device memory, or that the micro-batch ran out of memory; it stops at the
first that fits. Prints the card, one JSON line per grad-accum, and exits 0
if one fitted.

    python3 scripts/torch_lres_fit.py --accums 1,2,4,8
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--accums", default="1,2,4,8")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--fp16-layers", type=int, default=0)
    ap.add_argument("--d-fp16-res", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_lres_fit: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from chip_smoke import LRES_BATCH, lres_train_steps
    from long_video_gan_tpu_torch.train_lres import build_config

    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    fitted = False
    for accum in (int(a) for a in args.accums.split(",")):
        c = build_config("", LRES_BATCH, accum, 1.0, "full", args.fp16_layers, args.d_fp16_res)
        record = dict(grad_accum=accum, micro_batch=LRES_BATCH // accum,
                      fp16_layers=args.fp16_layers, d_fp16_res=args.d_fp16_res)
        try:
            gan, per_step, step_s, collector, peak_gib, lacking, _ = lres_train_steps(
                c, device, range(args.steps))
            collector.update()
            record.update(fits=True, step_s=step_s, phases_s=per_step, peak_gib=peak_gib,
                          G_loss=collector.mean("loss/G_loss"),
                          D_loss=collector.mean("loss/D_loss"), lacking_grads=lacking)
            del gan
        except torch.cuda.OutOfMemoryError as e:
            record.update(fits=False, error=str(e).splitlines()[0][:200],
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(record), flush=True)
        fitted = fitted or record["fits"]
        if record["fits"]:
            break
    return 0 if fitted else 1


if __name__ == "__main__":
    sys.exit(main())
