"""Per-layer time budget of the PyTorch port's sres synthesis stack on one NVIDIA
GPU.

For every layer of the 144x256 plan (`SynthesisNetwork` at w_dim 512,
`num_fp16_res=4`), at `--segment` frames (a 16-frame segment with 2 x 4
context is 24) in the layer's own type, it times (a) `modulated_conv2d` and
(b) `filtered_lrelu` under each of `--impls` (`auto`: the layer's policy,
K1 on the bf16 layers; `fused`: K3a; `conv`: the composed path; `pallas`:
K4, on request). Times are CUDA events over `--iters` launches after a
warm-up launch. Prints the card, a table and the totals. K4 refuses the top
crops py0 <= -up (L3, L5, L7, L10, L13 of this plan); those cells read
"n/a", and any other error raises.

    python3 scripts/torch_bench_layers.py
    python3 scripts/torch_bench_layers.py --impls auto,fused,pallas --iters 50
    python3 scripts/torch_bench_layers.py --segment 1 --iters 1 --device cpu   # host clock
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path
from typing import Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from long_video_gan_tpu_torch.models.generator_sres import (SynthesisNetwork,  # noqa: E402
                                                            modulated_conv2d)
from long_video_gan_tpu_torch.ops.filtered_lrelu import (auto_impl_policy,  # noqa: E402
                                                         filtered_lrelu)
from long_video_gan_tpu_torch.utils.misc import cli_device  # noqa: E402

IMPLS = ("auto", "fused", "conv")
COND_CHANNELS = 27


def plan_network(device, w_dim: int = 512, img_width: int = 256, img_height: int = 144,
                 **kwargs) -> SynthesisNetwork:
    """The synthesis stack whose layers are timed (weights unused)."""
    return SynthesisNetwork(w_dim=w_dim, img_width=img_width, img_height=img_height,
                            img_channels=3, cond_channels=COND_CHANNELS,
                            **{"num_fp16_res": 4, **kwargs}, device=device)


def layer_rows(net: SynthesisNetwork) -> list[dict]:
    """Each layer's geometry: channels in (with the conditioning) and out,
    (height, width) in, after the conv, and out, up, down, the conv kernel,
    the padding and the type its conv and filtered_lrelu run in."""
    rows = []
    for name, layer in zip(net.layer_names, net.layers):
        k = layer.kernel
        h, w = layer.in_size[1], layer.in_size[0]
        rows.append(dict(name=name, in_channels=layer.in_channels,
                         out_channels=layer.out_channels, in_hw=(h, w),
                         conv_hw=(h + k - 1, w + k - 1),
                         out_hw=(layer.out_size[1], layer.out_size[0]),
                         up=layer.up_factor, down=layer.down_factor, kernel=k,
                         padding=tuple(layer.padding),
                         dtype="bfloat16" if layer.use_fp16 else "float32"))
    return rows


def time_ms(fn, iters: int, device: torch.device) -> float:
    """Mean ms of `fn` over `iters` launches after one warm-up: CUDA events
    on the card, the host clock on the CPU."""
    if device.type == "cuda":
        from long_video_gan_tpu_torch.selftest import _time_ms

        return _time_ms(fn, iters)
    fn()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - start) * 1e3 / iters


def filtered_lrelu_of(layer, impl: str):
    """The layer's filtered_lrelu call under `impl` ("auto": its policy)."""
    if impl == "auto":
        impl = auto_impl_policy(layer.up_factor, layer.in_size[0] * layer.in_size[1],
                                use_fp16=layer.use_fp16)

    def run(x, b):
        return filtered_lrelu(x, layer.up_filter, layer.down_filter, b.to(x.dtype),
                              up=layer.up_factor, down=layer.down_factor,
                              padding=layer.padding,
                              gain=1.0 if layer.is_torgb else math.sqrt(2.0),
                              slope=1.0 if layer.is_torgb else 0.2,
                              clamp=layer.conv_clamp, impl=impl)
    return run


@torch.inference_mode()
def bench_layers(net: SynthesisNetwork, frames: int, impls, iters: int,
                 generator: torch.Generator) -> list[dict]:
    """`layer_rows` with each layer's `conv_ms` and `flr_ms` {impl: ms, or
    None where K4 refuses the layer's top crop}."""
    device = net.layers[0].weight.device
    rows = layer_rows(net)
    for row, layer in zip(rows, net.layers):
        dtype = getattr(torch, row["dtype"])

        def randn(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=generator).to(device, dtype)

        x = randn(frames, row["in_channels"], *row["in_hw"], dtype=dtype)
        w = randn(row["out_channels"], row["in_channels"], row["kernel"], row["kernel"])
        s = randn(frames, row["in_channels"])
        row["conv_ms"] = time_ms(lambda: modulated_conv2d(
            x, w, s, demodulate=not layer.is_torgb, padding=row["kernel"] - 1), iters, device)
        xc = randn(frames, row["out_channels"], *row["conv_hw"], dtype=dtype)
        b = randn(row["out_channels"])
        row["flr_ms"] = {}
        for impl in impls:
            run = filtered_lrelu_of(layer, impl)
            try:
                row["flr_ms"][impl] = time_ms(lambda: run(xc, b), iters, device)
            except ValueError:
                if not (impl == "pallas" and layer.padding[2] <= -layer.up_factor):
                    raise
                row["flr_ms"][impl] = None   # K4's documented refusal
    return rows


def print_table(rows: list[dict], impls) -> dict:
    """The per-layer table and the totals; returns {"modulated_conv2d": ms,
    impl: ms}."""
    print(f"{'L':>2} {'shape in':>14} {'ch':>9} {'up':>2} {'dn':>2} {'dt':>8} "
          f"{'conv ms':>8} " + " ".join(f"{('flr:' + i):>10}" for i in impls))
    totals = {"modulated_conv2d": 0.0, **{impl: 0.0 for impl in impls}}
    for li, r in enumerate(rows):
        totals["modulated_conv2d"] += r["conv_ms"]
        cells = ""
        for impl in impls:
            ms: Optional[float] = r["flr_ms"][impl]
            totals[impl] += ms or 0.0
            cells += f" {'n/a':>10}" if ms is None else f" {ms:10.3f}"
        h, w = r["in_hw"]
        print(f"{li:>2} {h:>5}x{w:<6} {r['in_channels']:>4}->{r['out_channels']:<4} "
              f"{r['up']:>2} {r['down']:>2} {r['dtype'][:4]:>8} {r['conv_ms']:8.3f}" + cells)
    print(f"\nconv total: {totals['modulated_conv2d']:.3f} ms")
    for impl in impls:
        print(f"filtered_lrelu total [{impl}]: {totals[impl]:.3f} ms")
    return totals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impls", default=",".join(IMPLS))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--segment", type=int, default=24, help="frames, context included")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a CUDA device, pass cpu")
    args = ap.parse_args(argv)
    device = cli_device(args.device)
    from long_video_gan_tpu_torch.utils.profiling import gpu_name_and_power_limit

    print(gpu_name_and_power_limit(device) or "cpu (host clock)")
    impls = args.impls.split(",")
    rows = bench_layers(plan_network(device), args.segment, impls, args.iters,
                        torch.Generator().manual_seed(0))
    print_table(rows, impls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
