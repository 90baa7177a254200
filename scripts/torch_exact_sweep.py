"""Times the f32-exact tensor-core forward (K4/K5's body,
long_video_gan_tpu_torch/csrc/filtered_lrelu_exact_tc.cu) at other block
shapes on one NVIDIA GPU: warps per block and the group of other-operand
blocks a warp takes (`kExactWarps`, `kExactG`). Each variant is the source
with those two constants replaced, built with the port's nvcc flags into
`long_video_gan_tpu_torch/_build/`, and launched through K4's wrapper at the
K4/K5 layers of the 144x256 plan (16 frames, each layer in its sres type),
held to K4's bars against its plain version, then timed in alternating
rounds (CUDA events, mean of 10 launches). Prints the card, the registers
and spills of each variant, per-layer times and the sums.

    python3 scripts/torch_exact_sweep.py                  # 16x1 8x2 16x2 8x1
    python3 scripts/torch_exact_sweep.py --variants 16x1 8x2
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

LAYERS = (0, 4, 6, 8, 9, 11, 12, 14)   # chip_smoke.EXACT_LAYERS
FRAMES = 16
ROUNDS = 2


def build_variant(warps: int, group: int):
    """The exact source with kExactWarps = warps and kExactG = group, built
    under `_build/` and loaded; returns (library, ptxas report)."""
    from long_video_gan_tpu_torch.ops.filtered_lrelu_cuda import TC_FWD_ARGS
    from long_video_gan_tpu_torch.utils import nvcc

    text = (nvcc.CSRC_DIR / "filtered_lrelu_exact_tc.cu").read_text()
    text, n = re.subn(r"kExactG = \d+, kExactWarps = \d+",
                      f"kExactG = {group}, kExactWarps = {warps}", text)
    if n != 1:
        raise RuntimeError("filtered_lrelu_exact_tc.cu no longer names kExactG, kExactWarps")
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = nvcc.BUILD_DIR / f"exact_tc_w{warps}_g{group}.cu"
    src.write_text(text)
    lib = nvcc.load_library(src, {f"lvg_{kernel}_tc_fwd_{suffix}": TC_FWD_ARGS
                                  for kernel in ("exact", "polyphase")
                                  for suffix in ("bf16", "f32")})
    return lib, nvcc.build_library(src).with_suffix(".log").read_text()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=["16x1", "8x2", "16x2", "8x1"],
                    help="WARPSxGROUP, e.g. 16x1")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_exact_sweep: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from long_video_gan_tpu_torch import selftest
    from long_video_gan_tpu_torch.ops import filtered_lrelu_exact as exact

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    variants = [tuple(int(v) for v in s.split("x")) for s in args.variants]
    libs = {}
    for v in variants:
        libs[v], report = build_variant(*v)
        regs = re.findall(r"Used (\d+) registers", report)
        spills = re.findall(r"(\d+) bytes spill stores", report)
        print(f"{v[0]} warps, group {v[1]}: registers {regs}, spill stores {spills}")
    layers = selftest.plan_layers()
    device = torch.device("cuda")
    k4 = selftest.KERNELS["K4"]
    sums = {v: 0.0 for v in variants}
    for rnd in range(ROUNDS):
        for i in LAYERS:
            name, layer = layers[i]
            dtype = selftest.layer_dtype(layer)
            x, fu, fd, kw = selftest._layer_inputs(
                layer, FRAMES, dtype, device, torch.Generator().manual_seed(i))
            times = []
            for v in variants if rnd % 2 == 0 else variants[::-1]:
                exact.library = lambda v=v: libs[v]
                with torch.no_grad():
                    if rnd == 0:
                        out = exact.exact_fwd_cuda(x, fu, fd, **kw)
                        check = selftest._against_plain(
                            name, out, dtype, lambda s: k4.plain(x[s].float(), fu, fd, **kw),
                            k4.tol(dtype), half_ulp=dtype == torch.bfloat16)
                        if not check.ok:
                            raise RuntimeError(f"{v} disagrees with plain at {name}: {check}")
                    ms = selftest._time_ms(lambda: exact.exact_fwd_cuda(x, fu, fd, **kw))
                sums[v] += ms / ROUNDS
                times.append(f"{v[0]}x{v[1]} {ms:.3f}")
            print(f"round {rnd} {name:<16} {str(dtype).split('.')[-1]:<8} ms: "
                  + "  ".join(sorted(times)), flush=True)
    print("sum over the layers, mean of the rounds (ms): "
          + ", ".join(f"{w}x{g} {t:.3f}" for (w, g), t in sums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
