"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the port's five CUDA
sources from the checkout (six kernels; K1 and K2 have a bf16 tensor-core
source and two f32 ones, K3a and K3b one tensor-core source for both types,
K4 and K5 another), prints the tensor-core kernels' registers, spills and HMMA
instruction counts (K1/K2 in bf16; K3a/K3b and K4/K5, each type), holds each
kernel against its plain version at every layer geometry its paths give it
(K1 forward at generation, per-layer-table, training and metric size, 16 to
512 frames, also against the f32 composed op up to 128; K2 backward at
training size and, untimed, at the recompute phase's 128 frames; the f32
kernels K1f32 and K2f32, which `auto` runs on the f32 heads L0-L2 and
counts apart, at the same sizes; K3a forward at generation,
per-layer-table and training size, K3b backward at
training size; K4 and K5 at generation size; K2 and K3b also at their own
act' decisions, through their check-only builds that write U, on three
seeded draws), with the
tensor-core kernels' executed rate and per-layer tables of time, bound and
share, holds the native JPEG decoder (built with g++ on the card's host,
against the system's libjpeg or Pillow's libjpeg-turbo) to PIL on every
frame of the metrics' synthetic datasets and fails if the host decodes with
PIL, then drives each path through the entry points a user calls:

- full-width two-stage generation through
  `long_video_gan_tpu_torch.generate.generate_video`, with the kernel policy
  (`resample_impl="auto"`: K1, K1f32) and with `resample_impl="fused"` (K3a);
- full-width sres training steps through `train_sres.train_step`, with G on
  "auto" (K1, K2, K1f32, K2f32) and on "fused" (K3a, K3b), each with a G
  micro-batch's gradient checked against the plain path; generation from the
  trained G_ema after a save/load round trip;
- K4 through `SynthesisLayer(resample_impl="pallas")` and K5 through its entry
  point `filtered_lrelu_pallas_v2`, at the full-width layers they serve;
- the quality metrics through `metrics.metric_main.calc_metric` on the
  full-width two-stage pipeline (K1 in every sres call, the 128-frame
  `fvd2048_128f` clip in one pass, `fvd2048_128f_subsample8f`'s 4 clips of
  128 frames in one pass) and a synthetic 144x256 dataset, with the
  port's I3D, InceptionV3 and C3D detectors (seeded random weights, scripted
  to files and loaded back through `get_detector`), each detector held on
  one batch to the same module on the CPU;
- data-parallel sres training at full width through `train_sres.train_step`
  in a world-1 NCCL process group, bit-equal to the same steps without one
  (deterministic algorithms in both), with the gradient all_reduce's bytes
  and time;
- two processes on the one card in a gloo group over CUDA tensors: the
  collectives gloo carries there, one step of each tiny trainer against one
  process's (`parallel.selfcheck`), and time-sharded lres synthesis at full
  width against the unsharded pass over the same noise;
- the measurement tools at full width through their functions:
  `bench_train` (sres with K1/K2, lres) at its swept defaults,
  `scripts/torch_profile_train.py`'s phase table and `torch.profiler` trace
  of one sres cycle (K1, K2, K1f32 and K2f32 counted in the trace as by the
  counters),
  `scripts/torch_bench_layers.py`'s per-layer table on `auto` (K1) and
  `fused` (K3a) at 24 frames, and `scripts/torch_bench_prefetch.py` at
  prefetch 0, 1 and 2 (K1);
- the trainers' recompute options through `bench_train`: `--block-remat` on
  the sres full preset at grad-accum 1 and the lres f32 preset at
  grad-accum 2 (the smallest that fit with it; without it 2 and 4), and
  `--remat` on the sres full preset, a step each with its peak memory (G's
  forward runs again in the backward: K1 counted once more per G
  micro-batch);
- the sres synthesis bench as a user runs it,
  `python -m long_video_gan_tpu_torch.bench`, on `auto` (K1) and `fused`
  (K3a), each in its own process (one JSON line on stdout, its guard's line
  on stderr), and its `--selftest` sweep.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare PARENT.log   # also the times of another
                                                 # commit's run in this call

`--compare` takes the output of another commit's `chip_smoke.py` (run on the
same card, in the same call) and puts its per-layer kernel times and its
end-to-end numbers beside this run's. Every phase raises on failure (exit
code != 0). On success the line before the last is a JSON summary of the
kernels, and the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints no
result. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import warnings
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

FRAMES = 64            # output frames of the generation phases
SEGMENT = 16           # sres window (bench.py configuration)
CONTEXT = 4
SRES_KWARGS = dict(hr_height=144, hr_width=256, lr_height=36, lr_width=64,
                   temporal_context=CONTEXT, num_fp16_res=4, resample_impl="auto")
MODEL_TOL = 0.05       # relative max-abs, kernel path vs plain (scripts/tpu_selftest.py)
TRAIN_BATCH = 32       # train_sres.py full preset
GRAD_ACCUM = 2         # the smallest that fits in 80 GB (1 runs out of memory)
TRAIN_STEPS = 4        # per path; step 0 (R1 and ADA) is left out of the warm time
GRAD_TOL = 0.05        # relative max-abs of G's parameter gradients, kernel path vs conv
GRAD_CLIPS = 4         # gradient check micro-batch: the plain path at 16 clips runs out of 80 GB
EXACT_LAYERS = (0, 4, 6, 8, 9, 11, 12, 14)   # K4/K5: one layer of each geometry they serve
GRADIENT_DRAWS = 3     # seeded draws of K2's and K3b's checks at training size
LRES_BATCH = 64        # train_lres.py full preset: 64 clips of 128 frames at 36x64, f32
LRES_GRAD_ACCUM = 4    # the smallest that fits in 80 GB (scripts/torch_lres_fit.py)
LRES_STEPS = (0, 1, 2, 16)   # step indices: 0 and 16 run R1 (r1_interval 16), 0 cold
LRES_RTOL = 1e-3       # card vs CPU at the tiny parity config: the CPU tests' bar
METRIC_ITEMS = 64      # fvd2048_16f, fid50k_full, is50k: items of each side
METRIC_LONG = 2        # fvd2048_128f: clips of each side
METRIC_LONG_FRAMES = 128   # ... which the sres G makes in one pass (K1 at 128 frames)
METRIC_SUBSAMPLE_CLIPS = 4   # fvd2048_128f_subsample8f: generated clips, one generator batch
METRIC_SUBSAMPLE_FRAMES = METRIC_SUBSAMPLE_CLIPS * METRIC_LONG_FRAMES   # in one pass (K1 at 512)
METRIC_UCF_ITEMS = 16  # isv2048_ucf: generated clips
DETECTOR_TOL = 1e-3    # card (TF32 off) vs CPU features, of their max |.|
JPEG_TOL = 1           # levels, native vs PIL where they link two libjpegs (the JAX
                       # package's tests/test_native_jpeg.py bar); 0 where they share one
SELF_FD_TOL = 1e-4     # |Fréchet distance of a stats set with itself|, of its covariance's trace
DP_STEPS = (0, 1)      # data-parallel sres steps: 0 runs R1 and ADA, 1 neither
DP_RANKS = 2           # processes on the one card over gloo
DP_RTOL = 1e-5         # their tiny steps against one process's (parallel.selfcheck's bar)
TEMPORAL_FRAMES = 1024     # time-sharded lres synthesis over DP_RANKS ranks
TEMPORAL_RTOL, TEMPORAL_ATOL = 1e-4, 2e-6   # tests/test_temporal_sharding.py's bar
BENCH_SRES_STEPS = 3   # bench_train's timed steps after its 2 warm-ups: R1 runs at step 0,
BENCH_LRES_STEPS = 1   # so sres's median is a step without it; lres's one step has it
PROFILE_STEPS = 1      # torch_profile_train's timed calls per phase
LAYER_FRAMES = 24      # torch_bench_layers: a 16-frame segment with 2 x 4 context
LAYER_IMPLS = ("auto", "fused")
LAYER_ITERS = 20
PREFETCH_DEPTHS = (0, 1, 2)   # torch_bench_prefetch: depths, segments, best of
PREFETCH_SEGMENTS = 8
PREFETCH_ITERS = 3
REMAT_SRES_ACCUM = 1   # the smallest grad-accums that fit with --block-remat (PERF.md):
REMAT_LRES_ACCUM = 2   # sres full preset, lres f32 preset
REMAT_STEPS = 1        # timed steps of each recompute run, cold (the first runs R1)
BENCH_IMPLS = ("auto", "fused")   # long_video_gan_tpu_torch.bench at its defaults
BENCH_TIMEOUT = 300    # seconds per bench process
SEED = 0

# The TPU kernel each one replaces (function that reaches pl.pallas_call).
REPLACES = {
    "K1": "long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py:212",
    "K2": "long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py:305",
    "K1f32": "long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py:212",
    "K2f32": "long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py:305",
    "K3a": "long_video_gan_tpu/ops/pallas/filtered_lrelu_fused.py:194",
    "K3b": "long_video_gan_tpu/ops/pallas/filtered_lrelu_fused.py:277",
    "K4": "long_video_gan_tpu/ops/pallas/filtered_lrelu_kernel.py:117",
    "K5": "long_video_gan_tpu/ops/pallas/filtered_lrelu_v2.py:66",
}


T_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def counters():
    """Kernel name -> (module, attribute) of its launch count (K1f32/K2f32:
    the f32 kernels, `selftest.F32_KERNELS`)."""
    from long_video_gan_tpu_torch.ops import (filtered_lrelu_cuda, filtered_lrelu_exact,
                                              filtered_lrelu_fused, filtered_lrelu_polyphase)

    return {"K1": (filtered_lrelu_cuda, "launches"),
            "K2": (filtered_lrelu_cuda, "bwd_launches"),
            "K1f32": (filtered_lrelu_cuda, "f32_launches"),
            "K2f32": (filtered_lrelu_cuda, "f32_bwd_launches"),
            "K3a": (filtered_lrelu_fused, "fwd_launches"),
            "K3b": (filtered_lrelu_fused, "bwd_launches"),
            "K4": (filtered_lrelu_exact, "launches"),
            "K5": (filtered_lrelu_polyphase, "launches")}


def reset_counts() -> None:
    for module, attr in counters().values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in counters().items()}


def auto_counts(forwards: int, backwards: int = 0) -> dict:
    """The launches `auto` makes in `forwards` forward and `backwards`
    backward passes of the full-width sres G: K1/K2 at the bf16 layers
    L3-L13, K1f32/K2f32 at the f32 heads L0-L2."""
    from long_video_gan_tpu_torch import selftest

    layers = selftest.plan_layers()
    out = {}
    for fwd, bwd in (("K1", "K2"), ("K1f32", "K2f32")):
        n = len(selftest.served_layers(fwd, layers))
        out[fwd] = n * forwards
        if backwards:
            out[bwd] = n * backwards
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="LOG",
                    help="another commit's chip_smoke.py output from this call, to compare")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1

    from long_video_gan_tpu_torch import selftest
    from long_video_gan_tpu_torch.generate import synthesize_lres
    from long_video_gan_tpu_torch.io.checkpoint import load_generator, save_generator
    from long_video_gan_tpu_torch.models import generator_lres, generator_sres
    from long_video_gan_tpu_torch.models.common import init_weights_
    from long_video_gan_tpu_torch.ops import (filtered_lrelu_cuda, filtered_lrelu_exact,
                                              filtered_lrelu_fused, filtered_lrelu_polyphase)
    from long_video_gan_tpu_torch.ops.filtered_lrelu import filtered_lrelu
    from long_video_gan_tpu_torch.train_sres import build_config, generator_config
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

    # 2. Build every kernel's library from the checkout's sources, one nvcc
    # each, all together.
    phase("build")
    # K1 and K2 on the bf16 layers: the tensor-core source; K1f32 and K2f32
    # on the f32 heads: the f32 sources. K4 and K5 share one library.
    sources = {"K1": filtered_lrelu_cuda.TC_SOURCE, "K2": filtered_lrelu_cuda.TC_SOURCE,
               "K1f32": filtered_lrelu_cuda.SOURCE, "K2f32": filtered_lrelu_cuda.BWD_SOURCE,
               "K3a": filtered_lrelu_fused.SOURCE, "K3b": filtered_lrelu_fused.SOURCE,
               "K4": filtered_lrelu_exact.SOURCE, "K5": filtered_lrelu_polyphase.SOURCE}
    libraries = (filtered_lrelu_cuda.tc_library, filtered_lrelu_cuda.library,
                 filtered_lrelu_cuda.bwd_library, filtered_lrelu_fused.library,
                 filtered_lrelu_exact.library)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        for future in [pool.submit(lib) for lib in libraries]:
            future.result()
    print(f"built {', '.join(sorted(set(sources.values())))} in "
          f"{time.perf_counter() - t0:.2f} s")
    tensor_core_report()

    # 2b. The native JPEG decoder on the card's host (built there with g++),
    # on the frames of the synthetic datasets the metrics phase reads.
    data_dir = tempfile.TemporaryDirectory()
    make_metric_datasets(data_dir.name)
    jpeg_phase(data_dir.name)

    # 3-4. Every kernel against its plain version at each layer geometry
    # that launches it, at the frame counts its paths give it: a generation
    # segment and a training micro-batch (clips x seq_length frames, from the
    # training config).
    c = build_config("", TRAIN_BATCH, GRAD_ACCUM, 1.0, "full")
    train_frames = TRAIN_BATCH // c["gan_kwargs"]["G_grad_accum"] * c["seq_length"]
    remat_frames = TRAIN_BATCH // REMAT_SRES_ACCUM * c["seq_length"]   # the recompute phase's
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    layers = selftest.plan_layers()
    checked = {}   # kernel -> {frames: (checks, ms, plain ms, bound ms, bound by)}
    for kernel, sizes, f32_extra in (("K1", (SEGMENT, LAYER_FRAMES, train_frames,
                                              METRIC_LONG_FRAMES, METRIC_SUBSAMPLE_FRAMES),
                                      (0, 3)),
                                     ("K2", (train_frames,), (0, 3)),
                                     ("K2", (remat_frames,), ()),
                                     ("K1f32", (SEGMENT, LAYER_FRAMES, train_frames,
                                                METRIC_LONG_FRAMES, METRIC_SUBSAMPLE_FRAMES), ()),
                                     ("K2f32", (train_frames, remat_frames), ()),
                                     ("K3a", (SEGMENT, LAYER_FRAMES, train_frames), (3,)),
                                     ("K3b", (train_frames,), (3,)),
                                     ("K4", (SEGMENT,), EXACT_LAYERS),
                                     ("K5", (SEGMENT,), EXACT_LAYERS)):
        for frames in sizes:
            # Inputs drawn on the card (1-15 GB a layer, minutes on the
            # host) for K1 at the subsample metric's 512 frames and K2 at the
            # recompute phase's 128 (each in the layers' type only, untimed
            # for K2: the smaller sizes check the f32 kernel and the composed
            # op), for the first of K2's and K3b's GRADIENT_DRAWS, and for
            # the f32 kernels (K1f32, K2f32; their own generators leave the
            # shared one's draws as they were).
            seed = {("K1", METRIC_SUBSAMPLE_FRAMES): SEED + 9, ("K2", remat_frames): SEED + 10,
                    ("K2", train_frames): SEED + 20, ("K3b", train_frames): SEED + 20}.get(
                        (kernel, frames), {"K1f32": SEED + 30, "K2f32": SEED + 31}.get(kernel))
            only_type = (kernel, frames) in (("K1", METRIC_SUBSAMPLE_FRAMES), ("K2", remat_frames))
            phase(f"{kernel} vs plain, 144x256 plan, {frames} frames")
            checked.setdefault(kernel, {})[frames] = check_kernel(
                layers, frames, device,
                gen if seed is None else torch.Generator(device=device).manual_seed(seed), kernel,
                () if only_type else f32_extra, vs_composed=kernel == "K1" and not only_type,
                time_it=(kernel, frames) not in (("K2", remat_frames), ("K2f32", remat_frames)))
    # K2 and K3b at their own act' decisions, and K2f32, on more seeded draws
    # at training size, untimed: the pass must not hang on one draw.
    for kernel in ("K2", "K3b", "K2f32"):
        for draw in range(1, GRADIENT_DRAWS):
            phase(f"{kernel} vs plain, 144x256 plan, {train_frames} frames, draw {draw + 1} "
                  f"of {GRADIENT_DRAWS}")
            check_kernel(layers, train_frames, device,
                         torch.Generator(device=device).manual_seed(SEED + 20 + draw), kernel,
                         time_it=False)

    _, layer = layers[3]
    x = torch.randn((1, 2, 31, 38), device=device, requires_grad=True)
    kw = dict(up=layer.up_factor, down=layer.down_factor, padding=layer.padding, clamp=256.0)
    fu, fd = layer.up_filter.to(device), layer.down_filter.to(device)
    for impl in ("packed", "fused"):
        y = filtered_lrelu(x, fu, fd, None, impl=impl, **kw)
        (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        try:
            torch.autograd.grad(g.square().sum(), x)
        except NotImplementedError as e:
            print(f"impl={impl}: double backward raises: {str(e)[:60]}...")
        else:
            raise RuntimeError(f"a second-order gradient through impl={impl} did not raise")
    x4 = torch.randn((1, 2, 40, 54), device=device, requires_grad=True)
    _, l4 = layers[4]
    y = filtered_lrelu(x4, l4.up_filter.to(device), l4.down_filter.to(device), None,
                       up=2, down=2, padding=l4.padding, impl="pallas")
    try:
        torch.autograd.grad(y.sum(), x4)
    except NotImplementedError as e:
        print(f"impl=pallas: gradient raises: {str(e)[:60]}...")
    else:
        raise RuntimeError("a gradient through K4 did not raise")
    # K4 and K5 raise where the JAX kernels fail: the top crops of L3 (up 4,
    # which K5 refuses first) and L13 (up 2).
    for entry, fn in (("K4", lambda *a, **k: filtered_lrelu(*a, impl="pallas", **k)),
                      ("K5", filtered_lrelu_polyphase.filtered_lrelu_pallas_v2)):
        for i in (3, 13):
            name, layer = layers[i]
            xi = torch.randn((1, 2, layer.in_size[1] + 2, layer.in_size[0] + 2), device=device)
            try:
                fn(xi, layer.up_filter.to(device), layer.down_filter.to(device), None,
                   up=layer.up_factor, down=layer.down_factor, padding=layer.padding)
            except ValueError as e:
                print(f"{entry} at {name}'s crop raises ValueError: {str(e)[:70]}...")
            else:
                raise RuntimeError(f"{entry} did not raise at {name}'s crop padding")
    print(f"kernel checks done at {time.perf_counter() - T_START:.1f} s")

    # 5. Full-width two-stage generation through the port's entry point.
    phase(f"generate_video: lres 36x64 + sres 144x256 (auto), {FRAMES} frames")
    wgen = torch.Generator(device="cpu").manual_seed(SEED)
    lres_G = init_weights_(generator_lres.VideoGenerator(device=device), wgen).eval()
    sres_G = init_weights_(generator_sres.VideoGenerator(**SRES_KWARGS, device=device),
                           wgen).eval()
    lres_G.requires_grad_(False)
    sres_G.requires_grad_(False)
    run_gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    n_seg = FRAMES // SEGMENT
    launches = {}
    launches["generate"] = generate_phase(lres_G, sres_G, run_gen, device, auto_counts(n_seg))

    # Warm timings of the two stages (host clock around synchronised work).
    lr_len = FRAMES + 2 * CONTEXT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lr_video = synthesize_lres(lres_G, lr_len, batch_size=1, generator=run_gen, device=device)
    torch.cuda.synchronize()
    print(f"lres {lr_len} frames 36x64: {time.perf_counter() - t0:.3f} s")
    end_to_end = {"auto frames/s": time_sres("auto", sres_G, lr_video, run_gen)}

    # 6. Model-level check: one full-width segment, kernel policy vs plain.
    phase("model check: one sres segment, resample_impl auto vs conv")
    plain_G = generator_sres.VideoGenerator(**{**SRES_KWARGS, "resample_impl": "conv"},
                                            device=device).eval()
    plain_G.load_state_dict(sres_G.state_dict())
    window = lr_video[:, :, :SEGMENT + 2 * CONTEXT]
    z = torch.randn((1, sres_G.latent_z_dim), generator=run_gen).to(device)
    with torch.inference_mode(), selftest.tf32_off():
        want = plain_G(window, z=z)
        model_err = rel_err(sres_G(window, z=z), want)
    print(f"segment rel_err {model_err:.3e} (tol {MODEL_TOL})")
    if not math.isfinite(model_err) or model_err > MODEL_TOL:
        raise RuntimeError(f"auto vs plain segment rel_err {model_err} > {MODEL_TOL}")

    # 6b. The same generation with every SynthesisLayer on "fused" (K3a; the
    # ToRGB identity resample stays composed).
    phase(f"generate_video: lres 36x64 + sres 144x256 (fused), {FRAMES} frames")
    fused_G = generator_sres.VideoGenerator(**{**SRES_KWARGS, "resample_impl": "fused"},
                                            device=device).eval()
    fused_G.load_state_dict(sres_G.state_dict())
    fused_G.requires_grad_(False)
    n_fused = len(selftest.served_layers("K3a", layers))
    launches["generate_fused"] = generate_phase(lres_G, fused_G, run_gen, device,
                                                {"K3a": n_fused * n_seg})
    end_to_end["fused frames/s"] = time_sres("fused", fused_G, lr_video, run_gen)
    with torch.inference_mode(), selftest.tf32_off():
        fused_err = rel_err(fused_G(window, z=z), want)
    print(f"fused segment rel_err vs conv {fused_err:.3e} (tol {MODEL_TOL})")
    if not math.isfinite(fused_err) or fused_err > MODEL_TOL:
        raise RuntimeError(f"fused vs plain segment rel_err {fused_err} > {MODEL_TOL}")
    del lres_G, sres_G, plain_G, fused_G, lr_video, want
    torch.cuda.empty_cache()

    # 7-8. Full-width sres training through the CLI's step, G on "auto", and
    # a G micro-batch's parameter gradients against the plain path.
    accum_G, accum_D = c["gan_kwargs"]["G_grad_accum"], c["gan_kwargs"]["D_grad_accum"]
    gan, batches, train_gen, launches["train"], end_to_end["auto s/step"] = train_phase(
        c, device, "auto", TRAIN_STEPS, checked, train_frames,
        auto_counts(TRAIN_STEPS * (accum_G + accum_D), TRAIN_STEPS * accum_G))
    grad_phase(gan, c, device, batches, train_gen, "auto",
               {k: n for k, n in auto_counts(0, 1).items() if k in ("K2", "K2f32")})

    # 9. Train to generate: save the trained G_ema, load it, generate.
    phase("trained G_ema: save_generator, load_generator, one 16-frame segment")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/G-ema.lvg"
        save_generator(path, gan.G_ema, generator_config(c))
        G_loaded, config = load_generator(path, device=device)
    for key, value in gan.G_ema.state_dict().items():
        if not torch.equal(G_loaded.state_dict()[key], value):
            raise RuntimeError(f"G_ema round trip changed {key}")
    lr_window = next(batches)["lr_video"][:1, :, :4].repeat(1, 1, 6, 1, 1)
    with torch.inference_mode():
        seg = G_loaded(lr_window, z=torch.randn((1, G_loaded.latent_z_dim), device=device))
    print(f"segment {tuple(seg.shape)} finite {bool(torch.isfinite(seg).all())} "
          f"(config kind {config['kind']})")
    if tuple(seg.shape) != (1, 3, SEGMENT, 144, 256) or not bool(torch.isfinite(seg).all()):
        raise RuntimeError("the trained G_ema did not generate a finite 16-frame segment")
    del gan, batches, G_loaded, seg
    torch.cuda.empty_cache()

    # 9b. Training with G on "fused": K3a in the G and D phases' generator
    # passes, K3b in the G phase's backward.
    fc = {**c, "gan_kwargs": {**c["gan_kwargs"], "G_kwargs": {
        **c["gan_kwargs"]["G_kwargs"], "resample_impl": "fused"}}}
    gan, batches, train_gen, launches["train_fused"], end_to_end["fused s/step"] = train_phase(
        fc, device, "fused", TRAIN_STEPS, checked, train_frames,
        {"K3a": TRAIN_STEPS * n_fused * (accum_G + accum_D),
         "K3b": TRAIN_STEPS * n_fused * accum_G})
    grad_phase(gan, fc, device, batches, train_gen, "fused", {"K3b": n_fused})
    del gan, batches
    torch.cuda.empty_cache()

    # 9c. Full-preset lres training: no hand kernel on this path, so every
    # count stays 0; then the round trips, and the tiny parity on the card.
    launches["train_lres"], lres_times = lres_train_phase(device)
    end_to_end.update(lres_times)
    if any(launches["train_lres"].values()):
        raise RuntimeError(f"lres training launched {launches['train_lres']}")
    lres_parity_phase(device)

    # 10. K4 through SynthesisLayer(resample_impl="pallas") and K5 through
    # its entry point, at the full-width layers they serve.
    launches["pallas"], launches["pallas_v2"] = forward_only_phase(layers, device, wgen)

    # 11. The quality metrics on the two-stage pipeline: K1 in every sres
    # call, at the shapes checked above.
    launches["metrics"], metric_numbers = metrics_phase(device, checked, data_dir.name)
    end_to_end.update(metric_numbers)
    data_dir.cleanup()

    # 12. Data-parallel sres training in a world-1 NCCL group: K1/K2 on the
    # distributed path, bit-equal to the plain path.
    launches["train_dp"], dp_numbers = data_parallel_phase(c, device)
    end_to_end.update(dp_numbers)

    # 13. Two processes on the one card over gloo: the trainers' global-batch
    # semantics and time-sharded lres synthesis.
    end_to_end.update(two_rank_phase(device))

    # 14. The measurement tools at full width, through their functions:
    # bench_train, a trace of an sres step, the per-layer table, prefetch.
    launches["tools"], tool_numbers = tools_phase(device, checked)
    end_to_end.update(tool_numbers)

    # 14b. The trainers' recompute options at full width: --block-remat at
    # the smallest grad-accums that fit with it, --remat on sres.
    launches["remat"], remat_numbers = remat_phase(device, checked)
    end_to_end.update(remat_numbers)

    # 15. The sres synthesis bench as a user runs it, each impl in its own
    # process, and its --selftest sweep.
    launches["bench"], bench_numbers = bench_phase()
    end_to_end.update(bench_numbers)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax",
                                                                   "long_video_gan_tpu"))
    if leaked:
        raise RuntimeError(f"the port imported the JAX side: {leaked[:5]}")

    names = {"K1": "filtered_lrelu_fwd", "K2": "filtered_lrelu_bwd",
             "K1f32": "flrelu_f32_fwd", "K2f32": "flrelu_f32_bwd",
             "K3a": "filtered_lrelu_fused_fwd", "K3b": "filtered_lrelu_fused_bwd",
             "K4": "filtered_lrelu_exact", "K5": "filtered_lrelu_polyphase"}
    entries = []
    for kernel, by_frames in checked.items():
        # The times at the largest size a path gives the kernel, of those timed.
        timed = {f: v for f, v in by_frames.items() if v[1] is not None}
        _, ms, plain_ms, bound_ms, bound_by = timed[max(timed)]
        by_path = {p: counts[kernel] for p, counts in launches.items() if counts[kernel]}
        entry = {
            "name": names[kernel],
            "route": "cuda",
            "source": sources[kernel],
            "replaces": REPLACES[kernel],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(k.max_abs_err for checks, *_ in by_frames.values()
                               for k in checks),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "frames": max(timed),
        }
        if len(timed) > 1:
            entry["ms_by_frames"] = {f: v[1:4] for f, v in timed.items()}
        entries.append(entry)
    for entry in entries:
        if not entry["launches"]:
            raise RuntimeError(f"{entry['name']} was launched no time on its paths")
    phase("per-layer kernel times" + (f" beside {args.compare}" if args.compare else ""))
    parent = {}
    if args.compare:
        with open(args.compare) as f:
            parent = parse_log(f.read())
    layer_tables(checked, parent, end_to_end)
    print(f"whole script {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def check_kernel(layers, frames: int, device, gen, kernel: str, f32_extra=(),
                 vs_composed: bool = False, time_it: bool = True):
    """`kernel` against its plain version at every plan layer its path runs
    it at (K4/K5: EXACT_LAYERS), in that layer's type and, with `time_it`,
    timed (and, with `vs_composed`, against the f32 composed op), and
    untimed in f32 at the `f32_extra` layers not already checked in f32;
    raises if any disagrees. Returns (the checks, kernel ms, plain ms, bound
    ms, what bounds it), the times summed over the timed checks (None
    untimed)."""
    import torch

    from long_video_gan_tpu_torch import selftest

    served = selftest.served_layers(kernel, layers)
    indices = EXACT_LAYERS if kernel in ("K4", "K5") else served
    if not set(indices) <= set(served):
        raise RuntimeError(f"{kernel} does not serve layers {sorted(set(indices) - set(served))}")
    entry = selftest.F32_KERNELS.get(kernel, kernel)   # K1f32/K2f32 run through K1/K2
    checks = [selftest.check_layer(layers[i][1], layers[i][0], frames,
                                   selftest.layer_dtype(layers[i][1]), device, gen,
                                   time_it=time_it,
                                   kernel=entry, vs_composed=vs_composed) for i in indices]
    checks += [selftest.check_layer(layers[i][1], layers[i][0], frames, torch.float32, device,
                                    gen, kernel=entry)
               for i in f32_extra
               if i not in indices or selftest.layer_dtype(layers[i][1]) != torch.float32]
    by_name = dict(layers)
    for c in checks:
        timing = ("" if c.ms is None else f" kernel {c.ms:.3f} ms plain {c.plain_ms:.3f} ms "
                  f"bound {c.bound_ms:.3f} ms ({c.bound_by}, {c.bound_ms / c.ms:.2%})")
        if c.composed_rel_err is not None:
            timing += f" vs f32 composed {c.composed_rel_err:.2e}"
        if c.ulp_share is not None:
            timing += (f" off by > 1 ulp {c.ulp_share:.2e} of the elements "
                       f"(tol {selftest.K1_ULP_SHARE:g})")
        if c.beyond_half_ulp_rel_err is not None:
            timing += f" beyond half a bf16 ulp {c.beyond_half_ulp_rel_err:.2e} (tol {c.tol:g})"
        if c.ms is not None and selftest.KERNELS[entry].f32_arithmetic:
            # K4/K5 were priced at the f32 CUDA-core peak before they ran on
            # the tensor cores: that bound beside today's, once per layer.
            old, old_by = selftest.bound(by_name[c.name], frames, getattr(torch, c.dtype),
                                         False, peak_flops=selftest.PEAK_FLOPS[torch.float32])
            timing += f" (at the f32 CUDA-core peak: {old:.3f} ms, {old_by}, {old / c.ms:.2%})"
        if c.ms is not None and kernel in TENSOR_CORE_KERNELS:
            flops = selftest.executed_flops(by_name[c.name], frames, kernel,
                                            getattr(torch, c.dtype))
            timing += f" executed {flops / c.ms / 1e9:.1f} TFLOP/s"
        print(selftest.describe(kernel, c, timing))
    failed = [c.name + "/" + c.dtype for c in checks if not c.ok]
    if failed:
        raise RuntimeError(f"{kernel} disagrees with its plain version at {failed}")
    timed = [c for c in checks if c.ms is not None]
    if not timed:
        return checks, None, None, None, None
    ms, plain_ms, bound_ms = (sum(getattr(c, a) for c in timed)
                              for a in ("ms", "plain_ms", "bound_ms"))
    by_ops = sum(c.bound_ms for c in timed if c.bound_by == "operations")
    bound_by = "operations" if by_ops >= bound_ms / 2 else "bytes"
    print(f"{kernel} at {frames} frames, {len(timed)} layers: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, {bound_ms / ms:.2%})")
    return checks, ms, plain_ms, bound_ms, bound_by


# The tensor-core kernels: (library source, kernel name) -> the kernel it runs.
TENSOR_CORE_KERNELS = {"K1": ("filtered_lrelu_tc.cu", "filtered_lrelu_fwd_tc_kernel"),
                       "K2": ("filtered_lrelu_tc.cu", "filtered_lrelu_bwd_tc_kernel"),
                       "K3a": ("filtered_lrelu_fused_tc.cu", "filtered_lrelu_fused_fwd_tc_kernel"),
                       "K3b": ("filtered_lrelu_fused_tc.cu", "filtered_lrelu_fused_bwd_tc_kernel"),
                       "K4": ("filtered_lrelu_exact_tc.cu", "filtered_lrelu_exact_tc_kernel"),
                       "K5": ("filtered_lrelu_exact_tc.cu", "filtered_lrelu_polyphase_tc_kernel")}


def tensor_core_report() -> None:
    """The tensor-core kernels' registers and spills (ptxas, kept beside the
    library) and HMMA instruction counts (cuobjdump -sass of the library), for
    each instantiation (K3a-K5: bf16 and f32 maps); raises unless each uses
    the tensor cores and spills nothing."""
    from long_video_gan_tpu_torch.utils.nvcc import build_library, find_nvcc

    cuobjdump = str(Path(find_nvcc()).parent / "cuobjdump")
    for source in sorted({src for src, _ in TENSOR_CORE_KERNELS.values()}):
        lib = build_library(source)
        # ptxas: "Compiling entry function '<mangled>'", then its usage lines.
        usage = {}
        for chunk in lib.with_suffix(".log").read_text().split("Compiling entry function '")[1:]:
            name = chunk.split("'")[0]
            regs = re.search(r"Used (\d+) registers", chunk)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
            usage[name] = (regs.group(1) if regs else "?", spills.groups() if spills else None)
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        hmma = {chunk.split()[0]: chunk.count("HMMA")
                for chunk in sass.split("Function : ")[1:]}
        for which, (src, kernel) in TENSOR_CORE_KERNELS.items():
            if src != source:
                continue
            names = sorted(n for n in usage if re.search(rf"\d{kernel}[IE]", n))
            if not names:
                raise RuntimeError(f"{which}'s kernel {kernel} is not in {lib.name}")
            for name in names:
                regs, spills = usage[name]
                count = hmma.get(name, 0)
                kind = "f32 maps" if re.search(rf"{kernel}IfE", name) else "bf16 maps"
                print(f"{which} tensor-core kernel {kernel} ({kind}): {regs} registers, "
                      f"spill stores/loads {spills or '?'} bytes, HMMA instructions {count}")
                if not count or spills != ("0", "0"):
                    raise RuntimeError(f"{which}'s kernel ({kind}) has no HMMA instruction or "
                                       f"spills registers")


def parse_log(text: str) -> dict:
    """Another chip_smoke.py run's output: {(kernel, layer, dtype, frames):
    ms} of its timed checks, and {"<label> frames/s" | "<label> s/step": x}
    of its end-to-end lines."""
    out, label = {}, None
    for line in text.splitlines():
        m = re.match(r"(K\w+) (L\d+)_\S+\s+(\w+)\s+out \((\d+),.* kernel ([\d.]+) ms", line)
        if m:
            out[m.group(1), m.group(2), m.group(3), int(m.group(4))] = float(m.group(5))
        m = re.match(r"sres \((\w+)\) .*: ([\d.]+) frames/s", line)
        if m:
            out[f"{m.group(1)} frames/s"] = float(m.group(2))
        m = re.match(r"== train_sres full preset, G (\w+):", line)
        if m:
            label = m.group(1)
        m = re.search(r"warm sec/step \(steps [\d-]+\) ([\d.]+)", line)
        if m and label:
            out[f"{label} s/step"] = float(m.group(1))
        m = re.match(r"lres warm sec/step without R1 ([\d.]+), with R1 ([\d.]+)", line)
        if m:
            out["lres s/step"], out["lres R1 step s"] = float(m.group(1)), float(m.group(2))
        if line.startswith('{"metric": "sres_synthesis_frames_per_sec'):
            record = json.loads(line)
            out[f"bench {record['impl']} frames/s"] = record["value"]
            out[f"bench {record['impl']} per-segment frames/s"] = record["per_segment_value"]
    return out


def layer_tables(checked: dict, parent: dict, end_to_end: dict) -> None:
    """Per kernel and frame count, each timed layer's ms beside the compared
    run's (`parent`, from `parse_log`; "-" without one), the bound and its
    share, and the sums; then the end-to-end numbers of both."""
    label = "compared" if parent else "compared (none: no --compare)"
    for kernel, by_frames in checked.items():
        for frames, (checks, *_) in sorted(by_frames.items()):
            timed = [c for c in checks if c.ms is not None]
            if not timed:
                continue
            print(f"-- {kernel}, {frames} frames: layer, dtype, this run ms, {label} ms, "
                  f"ratio, bound ms (by), share of bound")
            sums = [0.0, 0.0]
            for c in timed:
                layer = c.name.split("_")[0]
                old = parent.get((kernel, layer, c.dtype, frames))
                sums[0] += c.ms
                sums[1] += old or 0.0
                ratio = f"{old / c.ms:.2f}x" if old else "-"
                print(f"{kernel} {frames:>3} fr {layer:<4} {c.dtype:<8} {c.ms:9.3f} "
                      f"{old if old else '-':>9} {ratio:>7} {c.bound_ms:8.3f} ({c.bound_by}) "
                      f"{c.bound_ms / c.ms:7.2%}")
            ratio = f"{sums[1] / sums[0]:.2f}x" if sums[1] else "-"
            print(f"{kernel} {frames:>3} fr sum  {len(timed)} layers {sums[0]:9.3f} "
                  f"{f'{sums[1]:.3f}' if sums[1] else '-':>9} {ratio:>7}")
    for key, value in end_to_end.items():
        old = parent.get(key)
        print(f"end to end {key}: this run {value:.3f}, {label} {old if old else '-'}")


def generate_phase(lres_G, sres_G, run_gen, device, expected: dict) -> dict:
    """`generate_video` of FRAMES frames with the counts reset just before;
    raises unless the video is finite, of the expected shape, and the
    kernels launched exactly `expected` times (others none). Returns the
    counts."""
    import torch

    from long_video_gan_tpu_torch.generate import generate_video

    reset_counts()
    t0 = time.perf_counter()
    video = torch.cat([seg.cpu() for seg in generate_video(
        lres_G, sres_G, FRAMES, segment_length=SEGMENT, generator=run_gen, device=device)],
        dim=2)
    first_run_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"video {tuple(video.shape)} finite {bool(torch.isfinite(video).all())} "
          f"range [{video.min().item():.3f}, {video.max().item():.3f}] "
          f"launches {counts} (expected {expected}), first run {first_run_s:.2f} s")
    if tuple(video.shape) != (1, 3, FRAMES, 144, 256):
        raise RuntimeError(f"unexpected video shape {tuple(video.shape)}")
    if not bool(torch.isfinite(video).all()):
        raise RuntimeError("video has non-finite values")
    if counts != {k: expected.get(k, 0) for k in counts}:
        raise RuntimeError(f"generation launched {counts}, expected {expected}")
    return counts


def time_sres(label: str, sres_G, lr_video, run_gen) -> float:
    """sres frames/s over FRAMES frames, median of 3 (host clock; the
    segments' `.cpu()` synchronises); prints and returns it."""
    from long_video_gan_tpu_torch.generate import super_resolve

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for seg in super_resolve(sres_G, lr_video, FRAMES, segment_length=SEGMENT,
                                 generator=run_gen):
            seg.cpu()
        runs.append(time.perf_counter() - t0)
    print(f"sres ({label}) {FRAMES} frames 144x256 (batch 1, segment {SEGMENT}, context "
          f"{CONTEXT}): {FRAMES / sorted(runs)[1]:.2f} frames/s "
          f"(median of 3: {', '.join(f'{s:.3f}' for s in runs)} s)")
    return FRAMES / sorted(runs)[1]


def synthetic_sres_batches(c: dict, device):
    """Seeded sres training batches made on the card: smooth random fields in
    [-1, 1] at the lr and hr clip shapes."""
    import torch

    data_gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ctx_len = c["seq_length"] + 2 * c["temporal_context"]
    while True:
        batch = {}
        for key, (h, w) in (("lr_video", (36, 64)), ("hr_video", (144, 256))):
            coarse = torch.rand((TRAIN_BATCH, 3, ctx_len, 9, 16), generator=data_gen,
                                device=device) * 2 - 1
            batch[key] = torch.nn.functional.interpolate(
                coarse, size=(ctx_len, h, w), mode="trilinear", align_corners=False)
        yield batch


# The wrapper function of each kernel that training and the tools launch.
WRAPPED = {"K1": "filtered_lrelu_fwd_cuda", "K2": "filtered_lrelu_bwd_cuda",
           "K1f32": "filtered_lrelu_fwd_cuda", "K2f32": "filtered_lrelu_bwd_cuda",
           "K3a": "fused_fwd_cuda", "K3b": "fused_bwd_cuda"}


@contextlib.contextmanager
def recorded_shapes(kernels):
    """Inside the block, record the output shape of every launch of each of
    `kernels` (of WRAPPED; K1/K2 on bf16 maps, K1f32/K2f32 on f32 maps, the
    same wrappers); yields {kernel: set of shapes}."""
    import torch

    seen = {k: set() for k in kernels}
    originals = []
    for kernel in kernels:
        module = counters()[kernel][0]
        fn = getattr(module, WRAPPED[kernel])
        originals.append((module, WRAPPED[kernel], fn))
        dtype = {"K1": torch.bfloat16, "K2": torch.bfloat16, "K1f32": torch.float32,
                 "K2f32": torch.float32}.get(kernel)

        def recording(*args, _fn=fn, _shapes=seen[kernel], _dtype=dtype, **kwargs):
            out = _fn(*args, **kwargs)
            if _dtype in (None, out.dtype):
                _shapes.add(tuple(out.shape))
            return out

        setattr(module, WRAPPED[kernel], recording)
    try:
        yield seen
    finally:
        for module, name, fn in reversed(originals):
            setattr(module, name, fn)


def train_phase(c: dict, device, label: str, steps: int, checked: dict, train_frames: int,
                expected: dict):
    """`steps` full-preset training steps on seeded synthetic videos made on
    the card, with the counts reset just before; raises unless losses are
    finite, G, D and G_ema change, the kernels launched exactly `expected`
    times (others none) and only at the shapes checked at `train_frames`.
    Returns (the trainer, its batches, its generator, the counts, the warm
    seconds per step)."""
    import torch

    from long_video_gan_tpu_torch.train.stats import Collector
    from long_video_gan_tpu_torch.train_sres import make_gan, train_step

    micro = TRAIN_BATCH // GRAD_ACCUM
    phase(f"train_sres full preset, G {label}: batch {TRAIN_BATCH}, grad_accum {GRAD_ACCUM} "
          f"(micro-batch {micro}), {steps} steps")
    gan = make_gan(c, device)
    gan.init_state(torch.Generator().manual_seed(SEED))
    batches = synthetic_sres_batches(c, device)
    snapshot = {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
                for name, m in (("G", gan.G), ("D", gan.D), ("G_ema", gan.G_ema))}
    train_gen = torch.Generator(device=device).manual_seed(SEED + 3)
    collector = Collector()
    torch.cuda.reset_peak_memory_stats()
    # Record the shape of every kernel output in training, to hold it to the
    # shapes checked above.
    reset_counts()
    step_s = []
    with recorded_shapes(expected) as seen:
        for step in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for stats in train_step(gan, train_gen, c, step, batches):
                collector.report(stats)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    collector.update()
    losses = {k: collector.mean(k) for k in ("loss/G_loss", "loss/D_loss", "loss/r1_loss",
                                             "loss/r1_penalty", "progress/augment_p")}
    print("losses " + ", ".join(f"{k} {v:.5g}" for k, v in losses.items()))
    warm = sum(step_s[1:]) / (steps - 1)
    print(f"step seconds {', '.join(f'{s:.3f}' for s in step_s)} (step 0 runs R1 and ADA); "
          f"warm sec/step (steps 1-{steps - 1}) {warm:.3f}; peak memory {peak_gib:.2f} GiB")
    print(f"launches {counts} (expected {expected})")
    if not all(math.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"non-finite training statistics: {losses}")
    if counts != {k: expected.get(k, 0) for k in counts}:
        raise RuntimeError("training launched the kernels other than its micro-batches imply")
    for kernel, shapes in seen.items():
        checks = checked[kernel][train_frames][0]
        want = {k.shape for k in checks if k.ms is not None}
        if shapes != want:
            raise RuntimeError(f"training ran {kernel} at {sorted(shapes ^ want)}, shapes not "
                               f"checked against its plain version")
    print(f"training ran {', '.join(seen)} at the {train_frames}-frame shapes checked above")
    for name, module in (("G", gan.G), ("D", gan.D), ("G_ema", gan.G_ema)):
        params = [k for k, _ in module.named_parameters()]
        state = module.state_dict()
        if all(torch.equal(snapshot[name][k], state[k]) for k in params):
            raise RuntimeError(f"training left {name} unchanged")
    print("G, D and G_ema changed")
    return gan, batches, train_gen, counts, warm


def grad_phase(gan, c: dict, device, batches, train_gen, label: str, expected: dict) -> None:
    """A G micro-batch of GRAD_CLIPS clips: the parameter gradients of the
    trainer's G path against the conv path (TF32 off); raises unless the
    backward kernel launched `expected` times and they agree to GRAD_TOL."""
    import torch

    from long_video_gan_tpu_torch import selftest
    from long_video_gan_tpu_torch.train_sres import make_gan

    phase(f"gradient check: one G micro-batch ({GRAD_CLIPS} clips), {label} vs conv, TF32 off")
    plain_gan = make_gan({**c, "gan_kwargs": {**c["gan_kwargs"], "G_kwargs": {
        **c["gan_kwargs"]["G_kwargs"], "resample_impl": "conv"}}}, device)
    plain_gan.G.load_state_dict(gan.G.state_dict())
    plain_gan.D.load_state_dict(gan.D.state_dict())
    plain_gan.ada_p = gan.ada_p.clone()
    lr_chunk = next(batches)["lr_video"][:GRAD_CLIPS]
    z = torch.randn((GRAD_CLIPS, gan.G.latent_z_dim), generator=train_gen, device=device)
    grads = []
    reset_counts()
    with selftest.tf32_off():
        for trainer in (gan, plain_gan):
            trainer.D.requires_grad_(False)
            loss, _ = trainer.G_micro_loss(torch.Generator(device=device).manual_seed(SEED + 4),
                                           lr_chunk, z=z)
            params = list(trainer.G.parameters())
            g = torch.autograd.grad(loss, params, allow_unused=True)
            grads.append(torch.cat([(t if t is not None else torch.zeros_like(p)).flatten()
                                    .float() for t, p in zip(g, params)]))
    counts = read_counts()
    if any(counts[k] != n for k, n in expected.items()):
        raise RuntimeError(f"the {label} gradient launched {counts}, expected {expected}")
    grad_err = rel_err(grads[0], grads[1])
    print(f"G gradient rel_err {grad_err:.3e} over {grads[0].numel()} parameters "
          f"(tol {GRAD_TOL})")
    if not math.isfinite(grad_err) or grad_err > GRAD_TOL:
        raise RuntimeError(f"{label} vs plain G gradient rel_err {grad_err} > {GRAD_TOL}")


def synthetic_lres_videos(c: dict, device):
    """Batches of `c["total_batch"]` real videos for the lres trainer made on
    the card from SEED: smooth random fields in [-1, 1] of its clip shape."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    size = (c["seq_length"], c["height"], c["width"])
    while True:
        coarse = torch.rand((c["total_batch"], 3, size[0] // 8, 9, 16), generator=gen,
                            device=device) * 2 - 1
        yield torch.nn.functional.interpolate(coarse, size=size, mode="trilinear",
                                              align_corners=False)


def lres_train_steps(c: dict, device, steps):
    """The full-preset lres trainer (`train_lres.make_gan`, weights from
    SEED) driven through `train_lres.train_step` at the step indices `steps`
    (which decide where R1 runs) on seeded synthetic videos made on the
    card, with each update method timed (synchronised) and each optimizer
    step preceded by a check that every
    parameter holds a finite gradient (R1 may leave a parameter it cannot
    reach without one). Returns (the trainer, per-step {phase: seconds},
    per-step seconds, the statistics' Collector, peak GiB, parameters that
    lacked a finite gradient, the modules among G, D and G_ema whose
    parameters the steps left unchanged)."""
    import torch

    from long_video_gan_tpu_torch.train.common import step_generator
    from long_video_gan_tpu_torch.train.stats import Collector
    from long_video_gan_tpu_torch.train_lres import make_gan, train_step

    gan = make_gan(c, device)
    gan.init_state(torch.Generator().manual_seed(SEED))
    phase_s, current = {}, [None]

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            current[0] = name
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            phase_s[name] = time.perf_counter() - t0
            return out
        return run

    for name in ("update_G", "update_D", "update_r1", "update_G_ema"):
        setattr(gan, name, timed(name, getattr(gan, name)))
    names = {id(gan.opt_G): [n for n, _ in gan.G.named_parameters()],
             id(gan.opt_D): [n for n, _ in gan.D.named_parameters()]}
    lacking = set()
    apply = gan._apply

    def checked_apply(opt, *args):
        r1 = current[0] == "update_r1"
        for name, p in zip(names[id(opt)], opt.params):
            if (p.grad is None and not r1) or (
                    p.grad is not None and not bool(torch.isfinite(p.grad).all())):
                lacking.add(name)
        return apply(opt, *args)

    gan._apply = checked_apply
    modules = {"G": gan.G, "D": gan.D, "G_ema": gan.G_ema}
    before = {name: [p.detach().clone() for p in m.parameters()] for name, m in modules.items()}
    batches = synthetic_lres_videos(c, device)
    collector = Collector()
    torch.cuda.reset_peak_memory_stats()
    per_step, step_s = [], []
    for step in steps:
        phase_s.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for stats in train_step(gan, step_generator(SEED, step, device), c, step, batches):
            collector.report(stats)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        per_step.append(dict(phase_s))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    unchanged = [name for name, m in modules.items()
                 if all(torch.equal(a, p) for a, p in zip(before[name], m.parameters()))]
    return gan, per_step, step_s, collector, peak_gib, sorted(lacking), unchanged


def lres_train_phase(device) -> tuple[dict, dict]:
    """Full-preset lres training (64 clips of 128 frames at 36x64 per step,
    f32) at LRES_GRAD_ACCUM and the step indices LRES_STEPS, the counts reset just
    before; raises unless the losses are finite, G, D and G_ema change and
    every parameter got a finite gradient. Then G_ema through
    save_generator / load_generator (every tensor equal, a finite video from
    the loaded one) and the train state through save_train_checkpoint /
    load_train_checkpoint (every tensor equal). Returns (the counts, the
    warm and R1 seconds per step)."""
    import torch

    from long_video_gan_tpu_torch.io.checkpoint import load_generator, save_generator
    from long_video_gan_tpu_torch.train.state import load_train_checkpoint, save_train_checkpoint
    from long_video_gan_tpu_torch.train_lres import build_config, generator_config, make_gan

    c = build_config("", LRES_BATCH, LRES_GRAD_ACCUM, 1.0, "full")
    micro = LRES_BATCH // LRES_GRAD_ACCUM
    phase(f"train_lres full preset: batch {LRES_BATCH} x {c['seq_length']} frames at "
          f"{c['height']}x{c['width']}, f32, grad_accum {LRES_GRAD_ACCUM} (micro-batch "
          f"{micro}), steps {LRES_STEPS}")
    reset_counts()
    gan, per_step, step_s, collector, peak_gib, lacking, unchanged = lres_train_steps(
        c, device, LRES_STEPS)
    counts = read_counts()
    collector.update()
    losses = {k: collector.mean(k) for k in ("loss/G_loss", "loss/D_loss", "loss/r1_loss",
                                             "loss/r1_penalty")}
    print("losses " + ", ".join(f"{k} {v:.5g}" for k, v in losses.items()))
    for step, total, phases in zip(LRES_STEPS, step_s, per_step):
        print(f"step {step}: {total:.3f} s (" + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()) + ")")
    # The warm steps: all but the first; with and without R1 apart.
    later = list(zip(LRES_STEPS[1:], step_s[1:]))
    warm_r1 = [s for step, s in later if step % c["r1_interval"] == 0]
    warm = [s for step, s in later if step % c["r1_interval"]]
    r1 = per_step[-1]
    print(f"per micro-batch of {micro}: D phase {r1['update_D'] / LRES_GRAD_ACCUM:.3f} s, "
          f"R1 {r1['update_r1'] / LRES_GRAD_ACCUM:.3f} s (step {LRES_STEPS[-1]})")
    warm, warm_r1 = sum(warm) / len(warm), sum(warm_r1) / len(warm_r1)
    print(f"lres warm sec/step without R1 {warm:.3f}, with R1 {warm_r1:.3f}; first step "
          f"(cold, R1) {step_s[0]:.3f} s; peak memory {peak_gib:.2f} GiB; launches {counts}")
    if not all(math.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"non-finite lres training statistics: {losses}")
    if lacking:
        raise RuntimeError(f"parameters without a finite gradient: {lacking[:10]}")
    if unchanged:
        raise RuntimeError(f"lres training left {unchanged} unchanged")
    print("every parameter received a finite gradient; G, D and G_ema changed")

    phase("lres G_ema and train state through .lvg")
    with tempfile.TemporaryDirectory() as tmp:
        save_generator(f"{tmp}/G-ema.lvg", gan.G_ema, generator_config(c))
        G_loaded, config = load_generator(f"{tmp}/G-ema.lvg", device=device)
        save_train_checkpoint(f"{tmp}/train.lvg", gan)
        back = make_gan(c, device)
        load_train_checkpoint(f"{tmp}/train.lvg", back)
    for key, value in gan.G_ema.state_dict().items():
        if not torch.equal(G_loaded.state_dict()[key], value):
            raise RuntimeError(f"G_ema round trip changed {key}")
    with torch.inference_mode():
        video = G_loaded(1, c["result_seq_length"],
                         generator=torch.Generator(device=device).manual_seed(SEED))
    print(f"loaded G_ema ({config['kind']}): video {tuple(video.shape)} finite "
          f"{bool(torch.isfinite(video).all())}")
    if (tuple(video.shape) != (1, 3, c["result_seq_length"], c["height"], c["width"])
            or not bool(torch.isfinite(video).all())):
        raise RuntimeError("the trained lres G_ema did not generate a finite video")
    pairs = [(f"{name}.{k}", v, getattr(back, name).state_dict()[k])
             for name in ("G", "G_ema", "D") for k, v in getattr(gan, name).state_dict().items()]
    for name in ("opt_G", "opt_D"):
        a, b = getattr(gan, name), getattr(back, name)
        if (a.count, a.lrate) != (b.count, b.lrate):
            raise RuntimeError(f"the train state round trip changed {name}'s count or lrate")
        pairs += [(f"{name}.mu/nu", x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu)]
    changed = [name for name, x, y in pairs if not torch.equal(x, y)]
    if changed or back.step != gan.step:
        raise RuntimeError(f"the train state round trip changed {changed[:5]} (step "
                           f"{back.step} vs {gan.step})")
    print(f"train state round trip: {len(pairs)} tensors equal, step {back.step}")
    del gan, back, G_loaded, video
    torch.cuda.empty_cache()
    return counts, {"lres s/step": warm, "lres R1 step s": warm_r1}


def lres_parity_phase(device) -> None:
    """One micro-batch of each lres phase at the tiny draw-free parity config
    (tests/test_torch_lres_train.py's) on the card, TF32 off, against the
    same micro-batch on the CPU: losses within LRES_RTOL, every parameter
    gradient within LRES_RTOL of the CPU gradient's max |.| for that
    tensor."""
    import torch

    from long_video_gan_tpu_torch import selftest
    from long_video_gan_tpu_torch.train.gan_lres import LowResVideoGAN

    phase("lres phases, tiny parity config: card (TF32 off) vs CPU")
    cfg = dict(seq_length=8, height=18, width=32, total_batch=8, diffaug_policy="",
               temp_scale_augment=0.0, G_random_temp_translate=False,
               G_kwargs=dict(temporal_emb_dim=64, latent_w_dim=64, temporal_padding=2,
                             channel_max=32, embedding_kwargs=dict(
                                 min_sampling_rate=10, max_sampling_rate=40, blur_widths=16)),
               D_kwargs=dict(channels_max=32, epilogue_kwargs=dict(channels=64)))
    gen = torch.Generator().manual_seed(SEED + 6)
    gans = {d: LowResVideoGAN(**cfg, device=d) for d in ("cpu", device)}
    gans["cpu"].init_state(gen)
    gans[device].G.load_state_dict(gans["cpu"].G.state_dict())
    gans[device].D.load_state_dict(gans["cpu"].D.state_dict())
    noise = [torch.randn(gans["cpu"].G.noise_shape(4, 8), generator=gen) for _ in range(2)]
    real = torch.rand((4, 3, 8, 18, 32), generator=gen) * 2 - 1
    results = {}
    with selftest.tf32_off():
        for d, gan in gans.items():
            out = {}
            gan.D.requires_grad_(False)
            loss, _ = gan.G_micro_loss(None, 4, noise=noise[0].to(d))
            out["G"] = (loss.item(), torch.autograd.grad(loss, list(gan.G.parameters()),
                                                         allow_unused=True))
            gan.D.requires_grad_(True)
            with torch.no_grad():
                fake = gan.generate(None, 4, gan.G_magnitude_ema_beta, noise=noise[1].to(d))
            loss, _, _ = gan.D_micro_loss(None, fake, real.to(d))
            out["D"] = (loss.item(), torch.autograd.grad(loss, list(gan.D.parameters()),
                                                         allow_unused=True))
            loss, _ = gan.r1_micro_loss(None, real.to(d))
            out["R1"] = (loss.item(), torch.autograd.grad(loss, list(gan.D.parameters()),
                                                          allow_unused=True))
            results[d] = out
    for name in ("G", "D", "R1"):
        (want, want_g), (got, got_g) = results["cpu"][name], results[device][name]
        if [g is None for g in got_g] != [w is None for w in want_g]:
            raise RuntimeError(f"the lres {name} phase reaches other parameters on the card")
        pairs = [(g.cpu(), w) for g, w in zip(got_g, want_g) if w is not None]
        # Each tensor against its max |CPU gradient|, floored at 1e-6 of the
        # largest (tests/test_torch_train.py's bar).
        floor = 1e-6 * max(w.abs().max().item() for _, w in pairs)
        worst = max(((g - w).abs().max() / max(w.abs().max().item(), floor)).item()
                    for g, w in pairs)
        print(f"{name}: loss card {got:.6g} cpu {want:.6g}, worst gradient error "
              f"{worst:.2e} of its tensor's max (tol {LRES_RTOL:g})")
        if not abs(got - want) <= LRES_RTOL * abs(want) or not worst <= LRES_RTOL:
            raise RuntimeError(f"the lres {name} phase on the card disagrees with the CPU")


def forward_only_phase(layers, device, wgen) -> tuple[dict, dict]:
    """K4 through the full-width SynthesisNetwork's layers on
    resample_impl="pallas", and K5 through `filtered_lrelu_pallas_v2` with
    each such layer's arguments, at EXACT_LAYERS with SEGMENT frames; each
    path with the counts reset just before. Returns the two paths' counts."""
    import torch

    from long_video_gan_tpu_torch import selftest
    from long_video_gan_tpu_torch.models.common import init_weights_
    from long_video_gan_tpu_torch.models.generator_sres import SynthesisNetwork
    from long_video_gan_tpu_torch.ops.filtered_lrelu_polyphase import filtered_lrelu_pallas_v2

    phase(f"impl=pallas (K4) through SynthesisLayer, filtered_lrelu_pallas_v2 (K5), "
          f"layers {EXACT_LAYERS}, {SEGMENT} frames")
    net = init_weights_(SynthesisNetwork(w_dim=512, img_width=256, img_height=144,
                                         img_channels=3, cond_channels=27, num_fp16_res=4,
                                         resample_impl="pallas", device=device), wgen).eval()
    inputs = {}
    for i in EXACT_LAYERS:
        layer = net.layers[i]
        w_in, h_in = layer.in_size
        inputs[i] = (torch.randn((SEGMENT, layer.in_channels, h_in, w_in), generator=wgen)
                     .to(device), torch.randn((SEGMENT, 512), generator=wgen).to(device))
    reset_counts()
    with torch.inference_mode():
        outs = {i: net.layers[i](*inputs[i]) for i in EXACT_LAYERS}
    torch.cuda.synchronize()
    k4 = read_counts()
    reset_counts()
    with torch.inference_mode():
        for i in EXACT_LAYERS:
            layer = net.layers[i]
            x = torch.randn((SEGMENT, layer.out_channels, layer.in_size[1] + layer.kernel - 1,
                             layer.in_size[0] + layer.kernel - 1),
                            generator=wgen).to(device, selftest.layer_dtype(layer))
            y = filtered_lrelu_pallas_v2(x, layer.up_filter, layer.down_filter,
                                         layer.bias.to(x.dtype), up=layer.up_factor,
                                         down=layer.down_factor, padding=layer.padding,
                                         gain=1.0 if layer.is_torgb else math.sqrt(2.0),
                                         slope=1.0 if layer.is_torgb else 0.2,
                                         clamp=layer.conv_clamp)
            outs[f"v2_{i}"] = y
    torch.cuda.synchronize()
    k5 = read_counts()
    n = len(EXACT_LAYERS)
    print(f"K4 path launches {k4}, K5 path launches {k5} (expected {n} each)")
    if k4 != {**{k: 0 for k in k4}, "K4": n} or k5 != {**{k: 0 for k in k5}, "K5": n}:
        raise RuntimeError("the K4/K5 paths launched other kernels or counts")
    for key, y in outs.items():
        if not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"non-finite output at {key}")
    return k4, k5


def _random_detector_file(module, example_shape, path: str, seed: int) -> str:
    """`module` with seeded random weights and batch-norm statistics, traced
    on the CPU and saved to `path` (a scripted detector file)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.8 + 0.4 * torch.rand(t.shape, generator=gen))
            elif name.endswith("running_mean") or name.endswith("bias"):
                t.copy_(0.02 * torch.randn(t.shape, generator=gen))
            elif t.ndim > 1:
                # He-scaled conv and linear weights (and batch-norm weights
                # near 1) keep the activations in range through the network.
                t.copy_(torch.randn(t.shape, generator=gen) * (2.0 / t[0].numel()) ** 0.5)
            elif t.is_floating_point() and t.ndim:
                t.copy_(1.0 + 0.1 * torch.randn(t.shape, generator=gen))
        with warnings.catch_warnings():   # the trace's shape arithmetic: harmless here
            warnings.simplefilter("ignore", torch.jit.TracerWarning)
            torch.jit.trace(module.eval(), torch.zeros(example_shape)).save(path)
    return path


class _TimedDetector:
    """A detector that adds its wall time (its numpy result is on the host,
    so the card is done) and its items to `totals`."""

    def __init__(self, detector, totals: dict):
        self.detector, self.totals = detector, totals

    def __call__(self, batch, **kwargs):
        t0 = time.perf_counter()
        out = self.detector(batch, **kwargs)
        self.totals["detector_s"] += time.perf_counter() - t0
        self.totals["detector_items"] += len(batch)
        return out


def make_metric_datasets(root: str) -> None:
    """The metrics phase's synthetic datasets, made with the port's tool:
    `<root>/data` (METRIC_ITEMS videos of 16 frames at 36x64 and 144x256)
    and `<root>/long` (METRIC_LONG of METRIC_LONG_FRAMES at 144x256)."""
    from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset

    lr = (SRES_KWARGS["lr_height"], SRES_KWARGS["lr_width"])
    hr = (SRES_KWARGS["hr_height"], SRES_KWARGS["hr_width"])
    t0 = time.perf_counter()
    make_synthetic_dataset(f"{root}/data", [lr, hr], num_videos=METRIC_ITEMS,
                           frames_per_video=16, num_partitions=4, seed=SEED)
    make_synthetic_dataset(f"{root}/long", [hr], num_videos=METRIC_LONG,
                           frames_per_video=METRIC_LONG_FRAMES, num_partitions=1, seed=SEED + 1)
    print(f"synthetic datasets: {METRIC_ITEMS} videos of 16 frames at {lr} and {hr}, "
          f"{METRIC_LONG} of {METRIC_LONG_FRAMES} at {hr}, in "
          f"{time.perf_counter() - t0:.1f} s")


def mapped_libjpeg() -> set:
    """Real paths of the libjpeg libraries mapped into this process (the
    system's `libjpeg.so.62*` or a wheel's `libjpeg-<hash>.so.62*`)."""
    with open("/proc/self/maps") as f:
        paths = {fields[5] for fields in (line.split(None, 5) for line in f) if len(fields) == 6}
    return {os.path.realpath(p.strip()) for p in paths
            if re.match(r"libjpeg(-[0-9a-f]+)?\.so", os.path.basename(p.strip()))}


def jpeg_phase(root: str) -> None:
    """Fails unless the native JPEG decoder loaded on the card's host (PIL
    is the fallback of hosts with no libjpeg at all). Then decodes every clip
    of the synthetic datasets under `root`, one clip a call as the dataset
    reads it, through the native decoder and through PIL, and holds them
    bit-equal where both run the same libjpeg file (one libjpeg mapped into
    the process), else within JPEG_TOL levels. Prints the largest
    difference, the share of elements that differ and each decoder's
    frames/s on the host clock."""
    import numpy as np

    from long_video_gan_tpu_torch.data import jpeg

    phase("JPEG decoder: native against PIL on the synthetic datasets' frames")
    decoder = jpeg.decoder_in_use()
    print(f"JPEG decoder: {decoder[:600]}")
    if not decoder.startswith("native"):
        raise RuntimeError("the card decodes JPEG with PIL: the native decoder did not load")
    from long_video_gan_tpu_torch.data import jpeg_native

    clips = []
    for shard in sorted(Path(root).glob("*/*/*.zip")):
        with zipfile.ZipFile(shard) as zf:
            index = json.loads(zf.read("frame_paths.json"))
            clips += [[zf.read(f"{clip}/{name}") for name in names]
                      for clip, names in sorted(index.items())]
    seconds = {"native": 0.0, "PIL": 0.0}
    max_diff, differ, elements, frames = 0, 0, 0, 0
    for blobs in clips:
        t0 = time.perf_counter()
        got = jpeg.decode_jpeg_batch(blobs)
        t1 = time.perf_counter()
        want = jpeg._decode_batch_pil(blobs)
        seconds["native"] += t1 - t0
        seconds["PIL"] += time.perf_counter() - t1
        if got.shape != want.shape:
            raise RuntimeError(f"native decoded {got.shape}, PIL {want.shape}")
        diff = np.abs(got.astype(np.int16) - want)
        max_diff = max(max_diff, int(diff.max()))
        differ += int(np.count_nonzero(diff))
        elements += diff.size
        frames += len(blobs)
    mapped = mapped_libjpeg()
    same = mapped == {os.path.realpath(jpeg_native.ROUTE.library)}
    tol = 0 if same else JPEG_TOL
    print(f"{len(clips)} clips, {frames} frames: largest difference {max_diff} levels, "
          f"{differ / elements:.3e} of {elements} elements differ (tol {tol}: "
          f"{'one libjpeg' if same else 'two libjpegs'} mapped, {sorted(mapped)}); native "
          f"{frames / seconds['native']:.1f} frames/s, PIL {frames / seconds['PIL']:.1f} "
          f"(one clip a call, host clock)")
    if frames == 0 or max_diff > tol:
        raise RuntimeError(f"the native JPEG decoder differs from PIL by {max_diff} levels "
                           f"(tol {tol}) over {frames} frames")


def metrics_phase(device, checked: dict, data_root: str) -> tuple[dict, dict]:
    """The seven-metric registry's entry point `calc_metric` on the
    full-width two-stage pipeline (lres `VideoGenerator()` defaults, the sres
    G at 144x256, `num_fp16_res=4`, `auto`; seeded random weights) against
    the synthetic datasets under `data_root` (`make_metric_datasets`):
    fvd2048_16f on METRIC_ITEMS real and generated clips, fvd2048_128f on
    METRIC_LONG (the sres G on 136 lr frames in one pass),
    fvd2048_128f_subsample8f on METRIC_SUBSAMPLE_CLIPS generated clips (one
    generator batch: the sres G on 4 x 136 lr frames in one pass, 512 output
    frames; the sres call's seconds and the peak memory printed), fid50k_full
    and is50k through the InceptionV3 on METRIC_ITEMS items, isv2048_ucf
    through the C3D on METRIC_UCF_ITEMS. The detectors have seeded random weights,
    are scripted to files and come back through `get_detector`. Each metric
    runs with the counts reset just before; raises unless its values are
    finite, K1 launched 11 times and K1f32 3 times per sres call (no other
    kernel) at the shapes checked against their plain versions, each
    detector's card features
    (TF32 off) agree with the same module's on the CPU within DETECTOR_TOL
    of their max |.|, and the Fréchet distance of a stats set with itself
    is about 0. Also fvd2048_16f once more with TF32 off. Returns (the
    counts summed over the metrics, the seconds per generated clip by
    metric, the subsample8f call's seconds and peak GiB)."""
    import copy

    import numpy as np
    import torch

    from long_video_gan_tpu_torch import selftest
    from long_video_gan_tpu_torch.metrics import metric_main, metric_utils
    from long_video_gan_tpu_torch.metrics.c3d import C3D, C3DDetector
    from long_video_gan_tpu_torch.metrics.detectors import get_detector
    from long_video_gan_tpu_torch.metrics.feature_stats import frechet_distance
    from long_video_gan_tpu_torch.metrics.i3d import I3DDetector, InceptionI3d
    from long_video_gan_tpu_torch.metrics.inception_v3 import InceptionDetector, InceptionV3
    from long_video_gan_tpu_torch.models import generator_lres, generator_sres
    from long_video_gan_tpu_torch.models.common import init_weights_
    from long_video_gan_tpu_torch.ops import filtered_lrelu_cuda

    phase("metrics through calc_metric: two-stage 36x64 -> 144x256 (auto), I3D, InceptionV3, "
          "C3D with random weights on a synthetic dataset")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    lr = (SRES_KWARGS["lr_height"], SRES_KWARGS["lr_width"])
    hr = (SRES_KWARGS["hr_height"], SRES_KWARGS["hr_width"])

    wgen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    lres_G = init_weights_(generator_lres.VideoGenerator(device=device), wgen).eval()
    sres_G = init_weights_(generator_sres.VideoGenerator(**SRES_KWARGS, device=device),
                           wgen).eval()
    lres_G.requires_grad_(False)
    sres_G.requires_grad_(False)
    # Each sres call's input shape and a CUDA event on each side of it: no
    # host sync, so every metric's s/clip is taken as without the hooks.
    sres_inputs, sres_events = [], []

    def sres_start(module, args):
        sres_inputs.append(tuple(args[0].shape))
        sres_events.append((torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)))
        sres_events[-1][0].record()

    def sres_end(module, args, out):
        sres_events[-1][1].record()

    sres_G.register_forward_pre_hook(sres_start)
    sres_G.register_forward_hook(sres_end)

    specs = {}
    for family, module, example, cls in (
            ("i3d", InceptionI3d(), (1, 3, 8, 32, 32), I3DDetector),
            ("inception", InceptionV3(), (1, 3, 75, 75), InceptionDetector),
            ("c3d", C3D(), (1, 3, 16, 112, 112), C3DDetector)):
        path = _random_detector_file(module, example, f"{tmp}/{family}.pt", SEED + len(specs))
        specs[family] = f"{family}:{path}"
        det = get_detector(specs[family], device)
        if not isinstance(det, cls):
            raise RuntimeError(f"get_detector({specs[family]!r}) gave {type(det).__name__}")
        for key, value in module.state_dict().items():
            if not torch.equal(det.module.state_dict()[key].cpu(), value):
                raise RuntimeError(f"{family}: the converted {key} differs from the file's")

    # Each detector's features on the card (TF32 off) against the same
    # module on the CPU, on one batch of the shapes the protocols give it.
    rng = np.random.default_rng(SEED)
    for family, shape in (("i3d", (1, 3, 16) + hr), ("inception", (4, 3) + hr),
                          ("c3d", (1, 3, 16) + hr)):
        det = get_detector(specs[family], device)
        cpu_det = type(det)(copy.deepcopy(det.module).cpu(), "cpu")
        batch = (rng.random(shape) * 255).astype(np.uint8)
        kwargs = dict(no_output_bias=True, return_probs=False) if family == "inception" else {}
        with selftest.tf32_off():
            got = det(batch, **kwargs)
        want = cpu_det(batch, **kwargs)
        err = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"{family} detector {shape}: card (TF32 off) vs CPU {err:.2e} of max |feature| "
              f"{np.abs(want).max():.4g} (tol {DETECTOR_TOL:g})")
        if not err <= DETECTOR_TOL:
            raise RuntimeError(f"the {family} detector on the card disagrees with the CPU")

    hr_data = dict(dataset_dir=f"{data_root}/data", seq_length=1, height=hr[0], width=hr[1])
    long_data = dict(hr_data, dataset_dir=f"{data_root}/long")
    base = dict(G=sres_G, lr_G=lres_G, device=device, cache_dir=f"{tmp}/cache",
                dataset_kwargs=hr_data)
    runs = [("fvd2048_16f", dict(detector=specs["i3d"], max_items_override=METRIC_ITEMS)),
            ("fvd2048_128f", dict(detector=specs["i3d"], max_items_override=METRIC_LONG,
                                  dataset_kwargs=long_data)),
            ("fvd2048_128f_subsample8f", dict(detector=specs["i3d"],
                                              max_items_override=METRIC_SUBSAMPLE_CLIPS,
                                              dataset_kwargs=long_data)),
            ("fid50k_full", dict(detector=specs["inception"], max_items_override=METRIC_ITEMS)),
            ("is50k", dict(detector=specs["inception"], max_items_override=METRIC_ITEMS)),
            ("isv2048_ucf", dict(detector=specs["c3d"], max_items_override=METRIC_UCF_ITEMS))]

    # Time the two sides and the detectors through the functions calc_metric
    # calls, and record the shape of every K1 and K1f32 output.
    totals = {}
    k1_shapes = set()
    originals = {name: getattr(metric_main, name) for name in (
        "compute_feature_stats_for_dataset", "compute_feature_stats_for_generator")}
    get = metric_utils.get_detector
    k1 = filtered_lrelu_cuda.filtered_lrelu_fwd_cuda

    def timed(name):
        def run(*args, **kwargs):
            before = totals["detector_s"]
            t0 = time.perf_counter()
            stats = originals[name](*args, **kwargs)
            seconds = time.perf_counter() - t0
            totals[name] = (seconds, totals["detector_s"] - before, stats)
            return stats
        return run

    def recording_k1(*args, **kwargs):
        out = k1(*args, **kwargs)
        k1_shapes.add(tuple(out.shape))
        return out

    counts_sum, per_clip, values, inputs, peaks, call_s = {}, {}, {}, {}, {}, {}
    try:
        for name in originals:
            setattr(metric_main, name, timed(name))
        metric_utils.get_detector = lambda spec, dev: _TimedDetector(get(spec, dev), totals)
        filtered_lrelu_cuda.filtered_lrelu_fwd_cuda = recording_k1
        for metric, kwargs in runs + [("fvd2048_16f", dict(runs[0][1], tf32=False))]:
            tf32 = kwargs.pop("tf32", True)
            if not tf32:
                kwargs["cache_dir"] = f"{tmp}/cache_tf32_off"
            totals.clear()
            totals.update(detector_s=0.0, detector_items=0)
            sres_inputs.clear()
            sres_events.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with contextlib.ExitStack() as stack:
                if not tf32:
                    stack.enter_context(selftest.tf32_off())
                result = metric_main.calc_metric(metric=metric, **{**base, **kwargs})
            counts = read_counts()
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            gen_s, gen_det_s, gen_stats = totals["compute_feature_stats_for_generator"]
            data_s, data_det_s, _ = totals.get("compute_feature_stats_for_dataset",
                                               (0.0, 0.0, None))
            label = metric if tf32 else f"{metric} (TF32 off)"
            values[label] = result["results"]
            inputs[label] = set(sres_inputs)
            torch.cuda.synchronize()
            peaks[label] = peak_gib
            call_s[label] = [start.elapsed_time(end) / 1e3 for start, end in sres_events]
            s_per_clip = (gen_s - gen_det_s) / gen_stats.num_items
            per_clip[f"{metric} s/clip" if tf32 else f"{metric} TF32 off s/clip"] = s_per_clip
            rate = totals["detector_items"] / totals["detector_s"]
            print(f"metric {label}: {result['results']}; generation {s_per_clip:.4f} s per "
                  f"clip ({gen_stats.num_items} clips, {len(sres_inputs)} sres calls of "
                  f"{sorted(set(sres_inputs))}); detector {rate:.1f} items/s "
                  f"({totals['detector_items']} items); dataset side {data_s:.2f} s (decode and "
                  f"read {data_s - data_det_s:.2f} s); total {result['total_time']:.2f} s; peak "
                  f"memory {peak_gib:.2f} GiB; launches {counts}")
            if not all(math.isfinite(v) for v in result["results"].values()):
                raise RuntimeError(f"{label} is not finite: {result['results']}")
            expected = {k: auto_counts(len(sres_inputs)).get(k, 0) for k in counts}
            if counts != expected:
                raise RuntimeError(f"{label} launched {counts}, expected 11 K1 and 3 K1f32 per "
                                   f"sres call ({len(sres_inputs)} calls) and nothing else")
            for k, v in counts.items():
                counts_sum[k] = counts_sum.get(k, 0) + v
    finally:
        for name, fn in originals.items():
            setattr(metric_main, name, fn)
        metric_utils.get_detector = get
        filtered_lrelu_cuda.filtered_lrelu_fwd_cuda = k1

    long_input = (1, 3, METRIC_LONG_FRAMES + 2 * SRES_KWARGS["temporal_context"]) + lr
    if inputs["fvd2048_128f"] != {long_input}:
        raise RuntimeError(f"fvd2048_128f called the sres G on {inputs['fvd2048_128f']}")
    print(f"fvd2048_128f: the sres G took {long_input} in one pass")
    sub = "fvd2048_128f_subsample8f"
    sub_input = (METRIC_SUBSAMPLE_CLIPS,) + long_input[1:]
    if inputs[sub] != {sub_input} or len(call_s[sub]) != 1:
        raise RuntimeError(f"{sub} called the sres G {len(call_s[sub])} times on {inputs[sub]}")
    print(f"{sub}: the sres G took {sub_input} in one pass ({METRIC_SUBSAMPLE_FRAMES} output "
          f"frames, K1 at {METRIC_SUBSAMPLE_FRAMES} frames) in {call_s[sub][0]:.3f} s (CUDA "
          f"events); peak "
          f"memory of the metric {peaks[sub]:.2f} GiB; {values[sub]}")
    per_clip[f"{sub} sres call s"], per_clip[f"{sub} peak GiB"] = call_s[sub][0], peaks[sub]
    want = {k.shape for kernel in ("K1", "K1f32") for frames in checked[kernel].values()
            for k in frames[0] if k.ms is not None}
    if not k1_shapes <= want:
        raise RuntimeError(f"the metrics ran K1/K1f32 at {sorted(k1_shapes - want)}, shapes not "
                           f"checked against their plain versions")
    print(f"the metrics ran K1 and K1f32 at {len(k1_shapes)} shapes, each checked against "
          f"plain above")
    print(f"TF32 on fvd2048_16f: {values['fvd2048_16f']['fvd2048_16f']!r} with cuDNN's "
          f"TF32 default, {values['fvd2048_16f (TF32 off)']['fvd2048_16f']!r} without")

    # The Fréchet distance of the fvd2048_16f real statistics with themselves.
    opts = metric_utils.MetricOptions(**{**base, **runs[0][1]})
    real = metric_utils.compute_feature_stats_for_dataset(
        opts, "i3d", {}, capture_mean_cov=True, max_items=2048, seq_length=16, frame_spacing=1)
    mu, sigma = real.get_mean_cov()
    self_fd = frechet_distance(mu, sigma, mu, sigma)
    print(f"Fréchet distance of the real fvd2048_16f stats with themselves {self_fd:.3e} "
          f"(trace of the covariance {np.trace(sigma):.4g}, tol {SELF_FD_TOL:g} of it)")
    if not abs(self_fd) <= SELF_FD_TOL * np.trace(sigma):
        raise RuntimeError("the Fréchet distance of a stats set with itself is not about 0")
    get_detector.cache_clear()
    del lres_G, sres_G
    tmp_dir.cleanup()
    torch.cuda.empty_cache()
    return counts_sum, per_clip


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (warning, not raising, where an op has none), TF32 off: two runs of one
    full-preset sres step from one state are then bit-equal on the card
    (without, 190 of its 199 tensors differ). Yields the warnings."""
    import torch

    from long_video_gan_tpu_torch import selftest

    previous = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with selftest.tf32_off(), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.backends.cudnn.deterministic = previous[0]
        torch.use_deterministic_algorithms(previous[1], warn_only=previous[2])


def data_parallel_phase(c: dict, device) -> tuple[dict, dict]:
    """The full sres preset's steps DP_STEPS through `train_sres.train_step`
    without a process group, then again from the same state, seed and
    batches in a world-1 NCCL group (every collective of the parallel layer
    runs), the counts reset just before: raises unless the two leave
    bit-equal states (parameters, G_ema, magnitude EMAs, w_avg, Adam
    moments, ada_p) and K1 and K2 launched. Returns (the counts, the
    seconds per step of both and the gradient all_reduce's ms)."""
    import torch
    import torch.distributed as dist

    from long_video_gan_tpu_torch.parallel import mesh, selfcheck
    from long_video_gan_tpu_torch.train.common import step_generator
    from long_video_gan_tpu_torch.train_sres import make_gan, train_step

    phase(f"data-parallel train_sres full preset, world 1 over NCCL: batch {TRAIN_BATCH}, "
          f"grad_accum {GRAD_ACCUM}, steps {DP_STEPS}, against no process group "
          f"(deterministic algorithms, TF32 off, in both)")
    source = synthetic_sres_batches(c, device)
    batches = [next(source) for step in DP_STEPS
               for _ in range(2 + (step % c["r1_interval"] == 0))]
    reduces = []

    def run():
        gan = make_gan(c, device)
        gan.init_state(torch.Generator().manual_seed(SEED))
        feed, step_s = iter(batches), []
        for step in DP_STEPS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(gan, step_generator(SEED, step, device), c, step, feed)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        return selfcheck.train_state(gan), step_s

    all_reduce_mean_ = mesh.all_reduce_mean_

    def timed_mean(tensors):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = all_reduce_mean_(tensors)
        end.record()
        reduces.append((len(tensors), sum(t.numel() * t.element_size() for t in tensors),
                        start, end))
        return out

    with deterministic() as caught:
        plain, plain_s = run()
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                                world_size=1)
        mesh.all_reduce_mean_ = timed_mean
        try:
            reset_counts()
            dp, dp_s = run()
            counts = read_counts()
        finally:
            mesh.all_reduce_mean_ = all_reduce_mean_
            dist.destroy_process_group()
    torch.cuda.synchronize()
    grads = [(n, b, s.elapsed_time(e)) for n, b, s, e in reduces if n > 1]
    scalars = [s.elapsed_time(e) for n, b, s, e in reduces if n == 1]
    # The group's first collective sets NCCL's communicator up.
    print(f"first collective (NCCL set-up) {reduces[0][2].elapsed_time(reduces[0][3]):.3f} ms")
    if reduces[0][0] == 1:
        scalars = scalars[1:]
    else:
        grads = grads[1:]
    print(f"ops without a deterministic implementation: {len({str(w.message) for w in caught})}")
    print(f"sec per step without a group {', '.join(f'{t:.3f}' for t in plain_s)}, world-1 "
          f"NCCL {', '.join(f'{t:.3f}' for t in dp_s)} (steps {DP_STEPS})")
    print("gradient all_reduce (one flat buffer per phase): " + ", ".join(
        f"{n} tensors {b / 2**20:.2f} MiB {ms:.3f} ms" for n, b, ms in grads))
    print(f"magnitude-EMA, w_avg and loss means: {len(scalars)} more scalar "
          f"all_reduces, {sum(scalars):.3f} ms in all")
    unequal = [k for k in plain if not torch.equal(plain[k], dp[k])]
    print(f"{len(plain) - len(unequal)} of {len(plain)} state tensors bit-equal; launches {counts}")
    if unequal:
        raise RuntimeError(f"the world-1 NCCL step changed {unequal[:5]}")
    if not counts["K1"] or not counts["K2"]:
        raise RuntimeError(f"data-parallel training launched {counts}, not K1 and K2")
    g_bytes = max(b for _, b, _ in grads)
    return counts, {"dp world-1 s/step": dp_s[-1], "plain s/step (deterministic)": plain_s[-1],
                    "dp grad all_reduce ms": max(ms for _, b, ms in grads if b == g_bytes)}


def two_rank_phase(device) -> dict:
    """DP_RANKS processes on the one card in a gloo group over CUDA tensors
    (`--rank-worker`): each checks that all_reduce, broadcast and all_gather
    carry CUDA tensors and give the right values, takes one step of each tiny
    trainer (`parallel.selfcheck.tiny_step`: ADA at p = 0.5, grad-accum 2, R1)
    and synthesizes TEMPORAL_FRAMES lres frames at the `VideoGenerator()`
    defaults time-sharded, default halo. This process computes the same
    without a group; raises unless the ranks agree with each other, the steps
    with one process's within DP_RTOL (deterministic algorithms, TF32 off) and
    the video with the unsharded pass. The video is made by G as trained
    (float32) and by a float64 copy of it (`temporal_models`), each sharded
    and unsharded, and held to the unsharded float64 pass: the float64 one
    within TEMPORAL_RTOL / TEMPORAL_ATOL, the float32 one within those plus
    how far the unsharded float32 pass itself lies beyond them. At full width
    on the card that is more than the bar's atol, which the JAX test set at
    a tiny width (PERF.md §6)."""
    import torch

    from long_video_gan_tpu_torch.parallel import selfcheck, temporal

    phase(f"{DP_RANKS} ranks on one card over gloo with CUDA tensors: the tiny trainers' step "
          f"against one process; lres synthesis of {TEMPORAL_FRAMES} frames time-sharded")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank-worker", tmp],
            env={**os.environ, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                 "RANK": str(r), "WORLD_SIZE": str(DP_RANKS)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_RANKS)]
        try:
            with deterministic():
                want = {kind: selfcheck.tiny_step(kind, device) for kind in ("lres", "sres")}
                models = temporal_models(device)
                G = models["float32"]
                halo = 8 * G.total_temporal_scale
                noise_len = G.noise_shape(1, TEMPORAL_FRAMES // DP_RANKS + 2 * halo)[2]
                noise = torch.randn((1, G.noise_channels, (DP_RANKS - 1) * TEMPORAL_FRAMES
                                     // DP_RANKS + noise_len),
                                    generator=torch.Generator().manual_seed(SEED + 6))
                with torch.no_grad():
                    want_video = {name: temporal._window_video_from_noise(
                        model, noise, TEMPORAL_FRAMES + 2 * halo)[
                            :, :, halo:halo + TEMPORAL_FRAMES].cpu()
                                  for name, model in models.items()}
                del G, models
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            print(f"rank {r}: " + out.strip().replace("\n", "\n  "))
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {DP_RANKS} exited with {p.returncode}")
        got = [torch.load(f"{tmp}/rank{r}.pt") for r in range(DP_RANKS)]
    for r in range(1, DP_RANKS):
        for kind in want:
            unequal = [k for k, v in got[0]["steps"][kind].items()
                       if not torch.equal(v, got[r]["steps"][kind][k])]
            if unequal:
                raise RuntimeError(f"ranks 0 and {r} differ after the {kind} step: {unequal[:5]}")
        for name in want_video:
            if not torch.equal(got[0]["video"][name], got[r]["video"][name]):
                raise RuntimeError(f"ranks 0 and {r} hold different {name} videos")
    for kind, one in want.items():
        params = selfcheck.param_keys(selfcheck.trainer(kind, "cpu")[2])
        errors = selfcheck.relative_errors(got[0]["steps"][kind], one, params)
        worst = max(errors, key=errors.get)
        print(f"{kind} step on {DP_RANKS} ranks vs 1: {len(errors)} tensors and statistics, "
              f"worst {worst} {errors[worst]:.3e} (bar {DP_RTOL})")
        if not errors[worst] <= DP_RTOL:
            raise RuntimeError(f"the {kind} step on {DP_RANKS} ranks is not one process's")

    exact = want_video["float64"]

    def beyond_rtol(video):
        """max of |video - exact| - rtol * |exact|: what atol must cover."""
        return ((video - exact).abs() - TEMPORAL_RTOL * exact.abs()).max().item()

    sharded = got[0]["video"]
    e64, e32 = beyond_rtol(sharded["float64"]), beyond_rtol(sharded["float32"])
    floor = beyond_rtol(want_video["float32"])
    print(f"time-sharded lres {tuple(exact.shape)} against the unsharded pass in float64, "
          f"beyond rtol {TEMPORAL_RTOL}: sharded in float64 {e64:.3e} (bar atol "
          f"{TEMPORAL_ATOL}); sharded in float32 {e32:.3e}, the unsharded float32 pass "
          f"{floor:.3e} (bar atol {TEMPORAL_ATOL} + the unsharded float32 pass's)")
    if (any(tuple(v.shape) != tuple(exact.shape) for v in sharded.values())
            or not e64 <= TEMPORAL_ATOL or not e32 <= TEMPORAL_ATOL + max(floor, 0.0)):
        raise RuntimeError("time-sharded lres synthesis is not the unsharded pass")
    seconds = time.perf_counter() - t0
    print(f"two-rank phase {seconds:.1f} s")
    return {"two-rank phase s": seconds}


def run_counted(label: str, expected: dict, fn, checked: dict, total: dict):
    """fn() with the counts reset and the kernels' shapes recorded; raises
    unless the counts are `expected` and every shape was checked against the
    plain version (a check in `checked`); adds the counts to `total`."""
    reset_counts()
    with recorded_shapes(expected) as seen:
        out = fn()
    counts = read_counts()
    print(f"{label}: launches {counts} (expected {expected})")
    if counts != {k: expected.get(k, 0) for k in counts}:
        raise RuntimeError(f"{label} launched {counts}, expected {expected}")
    for kernel, shapes in seen.items():
        done = {c.shape for checks, *_ in checked[kernel].values() for c in checks}
        if not shapes <= done:
            raise RuntimeError(f"{label} ran {kernel} at unchecked shapes "
                               f"{sorted(shapes - done)}")
    for k, n in counts.items():
        total[k] += n
    return out


def tools_phase(device, checked: dict) -> tuple[dict, dict]:
    """Each measurement tool once at full width through its functions, the
    counts reset just before: `bench_train` sres and lres at their swept
    defaults, `torch_profile_train`'s phase table and trace of one sres
    cycle (its chrome trace in a temporary directory), `torch_bench_layers`
    on LAYER_IMPLS, `torch_bench_prefetch` at PREFETCH_DEPTHS. Raises
    unless each launched exactly the kernels its work implies, only at
    shapes checked above, the losses are finite, and the trace holds K1, K2,
    K1f32 and K2f32 under their own categories as often as the counters say, in no more
    device time than its wall time. Returns (the counts, the numbers)."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import torch_bench_layers
    import torch_bench_prefetch
    import torch_profile_train

    from long_video_gan_tpu_torch import bench_train, selftest

    n_fused = len(selftest.served_layers("K3a", selftest.plan_layers()))
    numbers, total = {}, {k: 0 for k in counters()}

    def run(label: str, expected: dict, fn):
        return run_counted(label, expected, fn, checked, total)

    phase(f"measurement tools: bench_train sres at its defaults "
          f"(grad_accum {bench_train.DEFAULT_SRES_ACCUM}), {BENCH_SRES_STEPS} steps")
    sres = bench_train.make_sres_bench(bench_train.DEFAULT_SRES_ACCUM, device=device)
    acc_g, acc_d = sres.gan.G_grad_accum, sres.gan.D_grad_accum
    cycles = len(bench_train.WARMUP_SEEDS) + BENCH_SRES_STEPS
    record = run("bench_train sres", auto_counts((acc_g + acc_d) * cycles, acc_g * cycles),
                 lambda: bench_train.measure(sres, BENCH_SRES_STEPS))
    print(json.dumps(record), flush=True)
    numbers["bench_train sres s/step"] = record["value"]

    phase(f"measurement tools: torch_profile_train --config sres, {PROFILE_STEPS} call(s) "
          f"per phase, then a trace of one cycle")
    calls = 1 + PROFILE_STEPS
    rows, step_s = run("phase timing", auto_counts((acc_g + acc_d) * calls, acc_g * calls),
                       lambda: torch_profile_train.time_phases(sres, PROFILE_STEPS))
    for r in rows:
        print(json.dumps(r))
    print(json.dumps({"config": "sres", **sres.record, "amortized_sec_per_step": step_s}))
    expected = auto_counts(acc_g + acc_d, acc_g)
    with tempfile.TemporaryDirectory() as tmp:
        traced = run("traced cycle", expected,
                     lambda: torch_profile_train.trace_cycle(sres, tmp, top=25))
    in_trace = {k: traced["categories"].get(f"{k} filtered_lrelu {way}", (0.0, 0))[1]
                for k, way in (("K1", "fwd"), ("K2", "bwd"), ("K1f32", "fwd"), ("K2f32", "bwd"))}
    idle = 1 - traced["device_sec"] / traced["wall_sec"]
    print(f"trace: {', '.join(f'{k} {n}' for k, n in in_trace.items())} launches (counters "
          f"{expected}); device {traced['device_sec']:.3f} s of {traced['wall_sec']:.3f} s "
          f"traced wall (idle {idle:.1%})")
    if in_trace != expected:
        raise RuntimeError(f"the trace holds {in_trace} K1/K2/K1f32/K2f32 launches, the "
                           f"counters {expected}")
    if traced["device_sec"] > traced["wall_sec"]:
        raise RuntimeError("the trace's device time exceeds its wall time")
    numbers["traced sres cycle device s"] = traced["device_sec"]
    del sres, traced
    torch.cuda.empty_cache()

    phase(f"measurement tools: bench_train lres at its defaults (grad_accum "
          f"{bench_train.DEFAULT_LRES_ACCUM}, G bf16 layers "
          f"{bench_train.DEFAULT_LRES_FP16_LAYERS}, D bf16 blocks "
          f"{bench_train.DEFAULT_LRES_D_FP16_RES}), {BENCH_LRES_STEPS} step")
    record = run("bench_train lres", {}, lambda: bench_train.bench_lres(
        bench_train.DEFAULT_LRES_ACCUM, BENCH_LRES_STEPS, bench_train.DEFAULT_LRES_FP16_LAYERS,
        bench_train.DEFAULT_LRES_D_FP16_RES, device=device))
    print(json.dumps(record), flush=True)
    numbers["bench_train lres s/step"] = record["value"]
    torch.cuda.empty_cache()

    phase(f"measurement tools: torch_bench_layers, {LAYER_FRAMES} frames, "
          f"{', '.join(LAYER_IMPLS)}, {LAYER_ITERS} launches each")
    net = torch_bench_layers.plan_network(device)
    layer_rows = run("per-layer table", {**auto_counts(1 + LAYER_ITERS),
                                         "K3a": n_fused * (1 + LAYER_ITERS)},
                     lambda: torch_bench_layers.bench_layers(
                         net, LAYER_FRAMES, LAYER_IMPLS, LAYER_ITERS,
                         torch.Generator().manual_seed(SEED)))
    totals = torch_bench_layers.print_table(layer_rows, LAYER_IMPLS)
    numbers.update({f"layers {k} ms": v for k, v in totals.items()})
    del net

    phase(f"measurement tools: torch_bench_prefetch, depths {PREFETCH_DEPTHS}, "
          f"{PREFETCH_SEGMENTS} segments, best of {PREFETCH_ITERS}")
    G, lr_video, z = torch_bench_prefetch.streaming_inputs(PREFETCH_SEGMENTS, SEGMENT, device)
    runs = 1 + len(PREFETCH_DEPTHS) * PREFETCH_ITERS
    records = run("prefetch sweep", auto_counts(PREFETCH_SEGMENTS * runs),
                  lambda: torch_bench_prefetch.sweep(G, lr_video, z, SEGMENT, PREFETCH_DEPTHS,
                                                     PREFETCH_ITERS))
    for r in records:
        print(json.dumps(r), flush=True)
        numbers[f"prefetch {r['prefetch']} frames/s"] = r["value"]
    del G, lr_video, z
    torch.cuda.empty_cache()
    return total, numbers


def remat_phase(device, checked: dict) -> tuple[dict, dict]:
    """The trainers' recompute options through bench_train: `--block-remat`
    on the sres full preset at REMAT_SRES_ACCUM and on the lres f32 preset
    (no bf16 ladders) at REMAT_LRES_ACCUM, the smallest grad-accums at which
    each fits with it (PERF.md), and `--remat` on the sres full preset at its
    default grad-accum; REMAT_STEPS timed steps each, with no warm-up (the
    first step, cold, runs R1: the times of warm steps are
    `scripts/torch_bench_train_sweep.py`'s), with the peak memory. Under either option the G phase
    runs G's forward once more in the backward, so K1 launches 2 x G_accum
    + D_accum times per served layer and cycle, K2 G_accum times. Raises
    unless the counts are those, every shape was checked and the losses are
    finite. Returns (the counts, the numbers)."""
    import torch

    from long_video_gan_tpu_torch import bench_train

    cycles = REMAT_STEPS
    numbers, total = {}, {k: 0 for k in counters()}
    runs = (("sres", "block_remat", REMAT_SRES_ACCUM), ("lres", "block_remat", REMAT_LRES_ACCUM),
            ("sres", "remat", bench_train.DEFAULT_SRES_ACCUM))
    for kind, option, accum in runs:
        phase(f"recompute: bench_train {kind} --{option.replace('_', '-')} at grad_accum "
              f"{accum}{' (f32)' if kind == 'lres' else ''}, {REMAT_STEPS} step(s)")
        torch.cuda.empty_cache()
        if kind == "sres":
            bench = bench_train.make_sres_bench(accum, device=device, **{option: True})
            g, d = bench.gan.G_grad_accum, bench.gan.D_grad_accum
            expected = auto_counts((2 * g + d) * cycles, g * cycles)
        else:
            bench = bench_train.make_lres_bench(accum, device=device, **{option: True})
            expected = {}
        record = run_counted(f"{kind} --{option}", expected,
                             lambda: bench_train.measure(bench, REMAT_STEPS, ()), checked,
                             total)
        print(json.dumps(record), flush=True)
        numbers[f"{option} {kind} s/step"] = record["value"]
        numbers[f"{option} {kind} peak GiB"] = record["peak_hbm_gb"]
        del bench
    torch.cuda.empty_cache()
    return total, numbers


def bench_phase() -> tuple[dict, dict]:
    """`python -m long_video_gan_tpu_torch.bench` at its defaults on each of
    BENCH_IMPLS, then `--selftest`, each in its own process on the card.
    Raises unless each bench prints exactly one JSON line on stdout, with
    finite positive frames/s in both protocols, 0 < mfu <= 1 and the same
    tflop_per_frame across the impls, and its guard's lines for each kernel
    the impl runs, passing, on stderr (none on stdout); unless each of those
    kernels launched once per served layer in every timed segment and no
    other kernel did;
    and unless --selftest exits 0 with every check passing (K2 and K3b at
    their own act' decisions). Returns (the timed calls' launches, the
    numbers)."""
    import torch

    from long_video_gan_tpu_torch import bench, selftest

    phase(f"sres synthesis bench: python -m long_video_gan_tpu_torch.bench --impl "
          f"{', '.join(BENCH_IMPLS)}, then --selftest, each its own process")
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    layers = selftest.plan_layers()
    launches, numbers, records = {k: 0 for k in counters()}, {}, {}
    t_phase = time.perf_counter()
    for impl in BENCH_IMPLS:
        ran = [kernel for kernel, _ in bench.GUARD[impl]]
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "long_video_gan_tpu_torch.bench", "--impl",
                              impl], cwd=root, capture_output=True, text=True,
                             timeout=BENCH_TIMEOUT)
        guard = [line for line in run.stderr.splitlines() if line.startswith("guard:")]
        print(f"bench --impl {impl}: exit {run.returncode} in {time.perf_counter() - t0:.1f} s; "
              f"stderr: {guard}")
        lines = run.stdout.splitlines()
        print(run.stdout, end="", flush=True)
        if run.returncode != 0 or len(lines) != 1:
            raise RuntimeError(f"bench --impl {impl} exited {run.returncode} with {len(lines)} "
                               f"stdout lines; stderr ends {run.stderr[-3000:]}")
        want_guard = [f"guard: impl={impl} {kernel} {layers[index][0]} "
                      for kernel, index in bench.GUARD[impl]]
        if (len(guard) != len(want_guard) or not all(
                line.startswith(want) and line.endswith(" ok")
                for line, want in zip(guard, want_guard))):
            raise RuntimeError(f"bench --impl {impl}: no passing guard lines {want_guard} on "
                               f"stderr: {guard}")
        r = records[impl] = json.loads(lines[0])
        rates = (r["value"], r["per_segment_value"])
        if r["impl"] != impl or not all(math.isfinite(v) and v > 0 for v in rates):
            raise RuntimeError(f"bench --impl {impl}: frames/s {rates} for impl {r['impl']}")
        if not 0 < r["mfu"] <= 1:
            raise RuntimeError(f"bench --impl {impl}: mfu {r['mfu']} outside (0, 1]")
        segments = r["iters"] * (r["chain"] + 1)
        want = {k: len(selftest.served_layers(k, layers)) * segments * r["batch"] if k in ran
                else 0 for k in r["launches"]}
        if r["launches"] != want:
            raise RuntimeError(f"bench --impl {impl} launched {r['launches']} in its timed "
                               f"calls, expected {want}")
        for k in ran:
            launches[k] += r["launches"][k]
        numbers[f"bench {impl} frames/s"] = r["value"]
        numbers[f"bench {impl} per-segment frames/s"] = r["per_segment_value"]
        numbers[f"bench {impl} mfu"] = r["mfu"]
    flops = {impl: r["tflop_per_frame"] for impl, r in records.items()}
    if len(set(flops.values())) != 1:
        raise RuntimeError(f"the bench's FLOP count differs across impls: {flops}")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "long_video_gan_tpu_torch.bench", "--selftest"],
                         cwd=root, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    lines = run.stdout.splitlines()
    print(f"bench --selftest: exit {run.returncode} in {time.perf_counter() - t0:.1f} s, "
          f"{len(lines)} lines:")
    print(run.stdout, end="", flush=True)
    summary = [line for line in lines if line.startswith(("selftest:", "model selftest"))]
    failing = [line for line in lines if "FAIL" in line]
    if len(summary) != 1 + len(bench.MODEL_IMPLS) or failing or run.returncode != 0:
        raise RuntimeError(f"bench --selftest exited {run.returncode} with {summary}, failing "
                           f"{failing}; stderr ends {run.stderr[-3000:]}")
    print(f"bench phase {time.perf_counter() - t_phase:.1f} s")
    return launches, numbers


def temporal_models(device) -> dict:
    """The lres G at the `VideoGenerator()` defaults with weights from SEED,
    as trained and as a float64 copy: {"float32": G, "float64": G64}."""
    import copy

    import torch

    from long_video_gan_tpu_torch.models import generator_lres
    from long_video_gan_tpu_torch.models.common import init_weights_

    G = init_weights_(generator_lres.VideoGenerator(device=device),
                      torch.Generator().manual_seed(SEED))
    return {"float32": G, "float64": copy.deepcopy(G).double()}


def rank_worker(out_dir: str) -> None:
    """One rank of `two_rank_phase`, on cuda:0 in a gloo group from RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT."""
    import torch
    import torch.distributed as dist

    from long_video_gan_tpu_torch.parallel import selfcheck, temporal

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world)
    total = torch.full((3,), float(rank + 1), device=device)
    dist.all_reduce(total)
    first = torch.full((3,), float(rank + 1), device=device)
    dist.broadcast(first, src=0)
    parts = [torch.empty(3, device=device) for _ in range(world)]
    dist.all_gather(parts, torch.full((3,), float(rank), device=device))
    carried = {"all_reduce": total.tolist() == [world * (world + 1) / 2] * 3,
               "broadcast": first.tolist() == [1.0] * 3,
               "all_gather": [p.tolist() for p in parts] == [[float(r)] * 3
                                                              for r in range(world)]}
    print(f"gloo on CUDA tensors: {carried}")
    if not all(carried.values()):
        raise RuntimeError(f"gloo did not carry CUDA tensors right: {carried}")
    with deterministic():
        steps = {kind: selfcheck.tiny_step(kind, device) for kind in ("lres", "sres")}
        with torch.no_grad():
            video = {name: temporal.synthesize_time_sharded(
                model, 1, TEMPORAL_FRAMES, torch.Generator().manual_seed(SEED + 6))
                     for name, model in temporal_models(device).items()}
    torch.save({"steps": steps, "video": {k: v.cpu() for k, v in video.items()}},
               f"{out_dir}/rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
