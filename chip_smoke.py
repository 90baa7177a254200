"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the port's CUDA
kernel from the checkout, holds it against its plain version at every layer
geometry it serves, drives full-width two-stage generation through
`long_video_gan_tpu_torch.generate.generate_video`, and checks the output.

    python3 chip_smoke.py

Every phase raises on failure (exit code != 0). On success the line before
the last is a JSON summary of the kernels, and the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints no
result. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

FRAMES = 64            # output frames of the generation phase
SEGMENT = 16           # sres window (bench.py configuration)
CONTEXT = 4
SRES_KWARGS = dict(hr_height=144, hr_width=256, lr_height=36, lr_width=64,
                   temporal_context=CONTEXT, num_fp16_res=4, resample_impl="auto")
MODEL_TOL = 0.05       # relative max-abs, auto vs plain (scripts/tpu_selftest.py)
SEED = 0


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1

    from long_video_gan_tpu_torch import selftest
    from long_video_gan_tpu_torch.generate import generate_video, super_resolve, synthesize_lres
    from long_video_gan_tpu_torch.models import generator_lres, generator_sres
    from long_video_gan_tpu_torch.models.common import init_weights_
    from long_video_gan_tpu_torch.ops import filtered_lrelu_cuda
    from long_video_gan_tpu_torch.utils.nvcc import find_nvcc

    device = torch.device("cuda")

    # 1. Device and toolchain.
    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    nvcc = subprocess.run([find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc {nvcc}, "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. Build the kernel from the checkout's sources.
    phase("build")
    t0 = time.perf_counter()
    filtered_lrelu_cuda.library()
    print(f"built {filtered_lrelu_cuda.SOURCE} in {time.perf_counter() - t0:.2f} s")

    # 3. Kernel against plain at each layer geometry that launches it.
    phase("kernel vs plain, 144x256 plan, 16 frames")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    layers = selftest.plan_layers()
    checks = []
    for idx in selftest.KERNEL_LAYERS:
        name, layer = layers[idx]
        checks.append(selftest.check_layer(layer, name, SEGMENT, torch.bfloat16, device, gen,
                                           time_it=True))
    for idx in (0, 3):
        name, layer = layers[idx]
        checks.append(selftest.check_layer(layer, name, SEGMENT, torch.float32, device, gen))
    for c in checks:
        timing = "" if c.ms is None else f" kernel {c.ms:.3f} ms plain {c.plain_ms:.3f} ms"
        print(f"{c.name:<16} {c.dtype:<8} out {c.shape} rel_err {c.rel_err:.2e} "
              f"(tol {selftest.TOLS[getattr(torch, c.dtype)]:g}){timing} "
              f"{'ok' if c.ok else 'FAIL'}")
    failed = [c.name + "/" + c.dtype for c in checks if not c.ok]
    if failed:
        raise RuntimeError(f"kernel disagrees with its plain version at {failed}")
    bf16 = [c for c in checks if c.ms is not None]
    kernel_ms = sum(c.ms for c in bf16)
    plain_ms = sum(c.plain_ms for c in bf16)
    print(f"L3-L13 per 16-frame segment: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms")

    # 4. Full-width two-stage generation through the port's entry point.
    phase(f"generate_video: lres 36x64 + sres 144x256, {FRAMES} frames")
    wgen = torch.Generator(device="cpu").manual_seed(SEED)
    lres_G = init_weights_(generator_lres.VideoGenerator(device=device), wgen).eval()
    sres_G = init_weights_(generator_sres.VideoGenerator(**SRES_KWARGS, device=device),
                           wgen).eval()
    lres_G.requires_grad_(False)
    sres_G.requires_grad_(False)
    run_gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    filtered_lrelu_cuda.launches = 0
    t0 = time.perf_counter()
    video = torch.cat([seg.cpu() for seg in generate_video(
        lres_G, sres_G, FRAMES, segment_length=SEGMENT, generator=run_gen, device=device)],
        dim=2)
    first_run_s = time.perf_counter() - t0
    launches = filtered_lrelu_cuda.launches
    expected = len(selftest.KERNEL_LAYERS) * (FRAMES // SEGMENT)
    print(f"video {tuple(video.shape)} finite {bool(torch.isfinite(video).all())} "
          f"range [{video.min().item():.3f}, {video.max().item():.3f}] "
          f"kernel launches {launches} (expected {expected}), first run {first_run_s:.2f} s")
    if tuple(video.shape) != (1, 3, FRAMES, 144, 256):
        raise RuntimeError(f"unexpected video shape {tuple(video.shape)}")
    if not bool(torch.isfinite(video).all()):
        raise RuntimeError("video has non-finite values")
    if launches != expected:
        raise RuntimeError(f"kernel launched {launches} times in the main path, "
                           f"expected {expected}")

    # Warm timings of the two stages (host clock around synchronised work).
    lr_len = FRAMES + 2 * CONTEXT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lr_video = synthesize_lres(lres_G, lr_len, batch_size=1, generator=run_gen, device=device)
    torch.cuda.synchronize()
    lres_s = time.perf_counter() - t0
    sres_runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for seg in super_resolve(sres_G, lr_video, FRAMES, segment_length=SEGMENT,
                                 generator=run_gen):
            seg.cpu()
        sres_runs.append(time.perf_counter() - t0)
    sres_s = sorted(sres_runs)[1]
    print(f"lres {lr_len} frames 36x64: {lres_s:.3f} s; sres {FRAMES} frames 144x256 "
          f"(batch 1, segment {SEGMENT}, context {CONTEXT}): {FRAMES / sres_s:.2f} frames/s "
          f"(median of 3: {', '.join(f'{s:.3f}' for s in sres_runs)} s)")

    # 5. Model-level check: one full-width segment, kernel policy vs plain.
    phase("model check: one sres segment, resample_impl auto vs conv")
    plain_G = generator_sres.VideoGenerator(**{**SRES_KWARGS, "resample_impl": "conv"},
                                            device=device).eval()
    plain_G.load_state_dict(sres_G.state_dict())
    window = lr_video[:, :, :SEGMENT + 2 * CONTEXT]
    z = torch.randn((1, sres_G.latent_z_dim), generator=run_gen).to(device)
    with torch.inference_mode(), selftest.tf32_off():
        got = sres_G(window, z=z)
        want = plain_G(window, z=z)
    model_err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"segment {tuple(got.shape)} rel_err {model_err:.3e} (tol {MODEL_TOL})")
    if not math.isfinite(model_err) or model_err > MODEL_TOL:
        raise RuntimeError(f"auto vs plain segment rel_err {model_err} > {MODEL_TOL}")

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax",
                                                                   "long_video_gan_tpu"))
    if leaked:
        raise RuntimeError(f"the port imported the JAX side: {leaked[:5]}")

    print(json.dumps({"kernels": [{
        "name": "filtered_lrelu_fwd",
        "route": "cuda",
        "source": filtered_lrelu_cuda.SOURCE,
        "replaces": "long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py:212",
        "launches": launches,
        "max_abs_err": max(c.max_abs_err for c in checks),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
