"""Where the PyTorch port's full-preset lres training spends its device time,
phase by phase, on one NVIDIA GPU: `LowResVideoGAN.update_G`, `.update_D`
and `.update_r1` (each one micro-batch with its backward and Adam step) at
`train_lres.py`'s full preset with `chip_smoke.py`'s micro-batch
(LRES_BATCH // LRES_GRAD_ACCUM clips of 128 frames at 36x64), seeded random
weights and `chip_smoke.synthetic_lres_videos`.

Each phase runs once to warm up, then once under `torch.profiler`. It
prints the card, each phase's wall seconds and device seconds, and its top
CUDA kernels by device time; one JSON line per phase.

    python3 scripts/torch_profile_lres.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TOP = 12        # kernels listed per phase


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_lres: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from chip_smoke import LRES_BATCH, LRES_GRAD_ACCUM, SEED, synthetic_lres_videos
    from long_video_gan_tpu_torch.train.common import step_generator
    from long_video_gan_tpu_torch.train_lres import build_config, make_gan

    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    micro = LRES_BATCH // LRES_GRAD_ACCUM
    c = build_config("", micro, 1, 1.0, "full")
    gan = make_gan(c, device)
    gan.init_state(torch.Generator().manual_seed(SEED))
    videos = synthetic_lres_videos(c, device)
    phases = {"G": lambda gen: gan.update_G(gen),
              "D": lambda gen: gan.update_D(gen, next(videos)),
              "R1": lambda gen: gan.update_r1(gen, next(videos), gain=float(c["r1_interval"]))}
    for step, (name, fn) in enumerate(phases.items()):
        fn(step_generator(SEED, step, device))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(step_generator(SEED, step + 100, device))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages() if e.device_time_total > 0
                  and e.device_type.name == "CUDA"]
        device_s = sum(e.device_time_total for e in events) / 1e6
        events.sort(key=lambda e: -e.device_time_total)
        print(f"== {name} micro-batch of {micro}: wall {wall:.3f} s, device {device_s:.3f} s")
        for e in events[:TOP]:
            print(f"{e.device_time_total / 1e6:8.3f} s {e.count:6d}x  {e.key[:110]}")
        print(json.dumps({"phase": name, "micro": micro, "wall_s": wall,
                          "device_s": device_s,
                          "top": [[e.key[:110], e.device_time_total / 1e6, e.count]
                                  for e in events[:TOP]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
