"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the port's CUDA
kernels from the checkout, holds each against its plain version at every layer
geometry it serves (K1 forward at generation and training size, K2 backward
at training size: the shapes training runs them at), drives full-width two-stage generation through
`long_video_gan_tpu_torch.generate.generate_video`, then three full-width sres
training steps through `train_sres.train_step`, checks a G micro-batch's
gradient against the plain path, and generates from the trained G_ema after a
save/load round trip.

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
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

FRAMES = 64            # output frames of the generation phase
SEGMENT = 16           # sres window (bench.py configuration)
CONTEXT = 4
SRES_KWARGS = dict(hr_height=144, hr_width=256, lr_height=36, lr_width=64,
                   temporal_context=CONTEXT, num_fp16_res=4, resample_impl="auto")
MODEL_TOL = 0.05       # relative max-abs, auto vs plain (scripts/tpu_selftest.py)
TRAIN_BATCH = 32       # train_sres.py full preset
GRAD_ACCUM = 2         # the smallest that fits in 80 GB (1 runs out of memory)
TRAIN_STEPS = 3
GRAD_TOL = 0.05        # relative max-abs of G's parameter gradients, auto vs conv
GRAD_CLIPS = 4         # gradient check micro-batch: the plain path at 16 clips runs out of 80 GB
SEED = 0


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1

    from long_video_gan_tpu_torch import selftest
    from long_video_gan_tpu_torch.generate import generate_video, super_resolve, synthesize_lres
    from long_video_gan_tpu_torch.io.checkpoint import load_generator, save_generator
    from long_video_gan_tpu_torch.models import generator_lres, generator_sres
    from long_video_gan_tpu_torch.models.common import init_weights_
    from long_video_gan_tpu_torch.ops import filtered_lrelu_cuda
    from long_video_gan_tpu_torch.train.stats import Collector
    from long_video_gan_tpu_torch.train_sres import (build_config, generator_config, make_gan,
                                                     train_step)
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

    # 2. Build both kernels from the checkout's sources, one nvcc each, together.
    phase("build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for future in [pool.submit(filtered_lrelu_cuda.library),
                       pool.submit(filtered_lrelu_cuda.bwd_library)]:
            future.result()
    print(f"built {filtered_lrelu_cuda.SOURCE} and {filtered_lrelu_cuda.BWD_SOURCE} "
          f"in {time.perf_counter() - t0:.2f} s")

    # 3. K1 against plain at each layer geometry that launches it, at the
    # frame counts its two paths give it: a generation segment and a training
    # micro-batch (clips x seq_length frames, from the training config).
    c = build_config("", TRAIN_BATCH, GRAD_ACCUM, 1.0, "full")
    train_frames = TRAIN_BATCH // c["gan_kwargs"]["G_grad_accum"] * c["seq_length"]
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    layers = selftest.plan_layers()
    fwd = {}
    for frames in (SEGMENT, train_frames):
        phase(f"K1 (forward) vs plain, 144x256 plan, {frames} frames")
        fwd[frames] = check_kernel(selftest.check_layer, layers, frames, device, gen, "K1")

    # 4. K2 against plain at training size.
    phase(f"K2 (backward) vs plain, 144x256 plan, {train_frames} frames")
    bwd = check_kernel(selftest.check_layer_bwd, layers, train_frames, device, gen, "K2")
    name, layer = layers[3]
    x = torch.randn((1, 2, 31, 38), device=device, requires_grad=True)
    y = filtered_lrelu_cuda.filtered_lrelu_packed(
        x, layer.up_filter.to(device), layer.down_filter.to(device), None,
        up=layer.up_factor, down=layer.down_factor, padding=layer.padding, clamp=256.0)
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    try:
        torch.autograd.grad(g.square().sum(), x)
    except NotImplementedError as e:
        print(f"double backward raises: {str(e)[:60]}...")
    else:
        raise RuntimeError("a second-order gradient through K2 did not raise")

    # 5. Full-width two-stage generation through the port's entry point.
    phase(f"generate_video: lres 36x64 + sres 144x256, {FRAMES} frames")
    wgen = torch.Generator(device="cpu").manual_seed(SEED)
    lres_G = init_weights_(generator_lres.VideoGenerator(device=device), wgen).eval()
    sres_G = init_weights_(generator_sres.VideoGenerator(**SRES_KWARGS, device=device),
                           wgen).eval()
    lres_G.requires_grad_(False)
    sres_G.requires_grad_(False)
    run_gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    filtered_lrelu_cuda.launches = filtered_lrelu_cuda.bwd_launches = 0
    t0 = time.perf_counter()
    video = torch.cat([seg.cpu() for seg in generate_video(
        lres_G, sres_G, FRAMES, segment_length=SEGMENT, generator=run_gen, device=device)],
        dim=2)
    first_run_s = time.perf_counter() - t0
    gen_launches = filtered_lrelu_cuda.launches
    expected = len(selftest.KERNEL_LAYERS) * (FRAMES // SEGMENT)
    print(f"video {tuple(video.shape)} finite {bool(torch.isfinite(video).all())} "
          f"range [{video.min().item():.3f}, {video.max().item():.3f}] "
          f"K1 launches {gen_launches} (expected {expected}), first run {first_run_s:.2f} s")
    if tuple(video.shape) != (1, 3, FRAMES, 144, 256):
        raise RuntimeError(f"unexpected video shape {tuple(video.shape)}")
    if not bool(torch.isfinite(video).all()):
        raise RuntimeError("video has non-finite values")
    if gen_launches != expected or filtered_lrelu_cuda.bwd_launches != 0:
        raise RuntimeError(f"generation launched K1 {gen_launches} times (expected {expected}) "
                           f"and K2 {filtered_lrelu_cuda.bwd_launches} times (expected 0)")

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

    # 6. Model-level check: one full-width segment, kernel policy vs plain.
    phase("model check: one sres segment, resample_impl auto vs conv")
    plain_G = generator_sres.VideoGenerator(**{**SRES_KWARGS, "resample_impl": "conv"},
                                            device=device).eval()
    plain_G.load_state_dict(sres_G.state_dict())
    window = lr_video[:, :, :SEGMENT + 2 * CONTEXT]
    z = torch.randn((1, sres_G.latent_z_dim), generator=run_gen).to(device)
    with torch.inference_mode(), selftest.tf32_off():
        model_err = rel_err(sres_G(window, z=z), plain_G(window, z=z))
    print(f"segment rel_err {model_err:.3e} (tol {MODEL_TOL})")
    if not math.isfinite(model_err) or model_err > MODEL_TOL:
        raise RuntimeError(f"auto vs plain segment rel_err {model_err} > {MODEL_TOL}")
    del lres_G, sres_G, plain_G, video, lr_video
    torch.cuda.empty_cache()

    # 7. Full-width sres training through the CLI's step.
    micro = TRAIN_BATCH // GRAD_ACCUM
    phase(f"train_sres full preset: batch {TRAIN_BATCH}, grad_accum {GRAD_ACCUM} "
          f"(micro-batch {micro}), {TRAIN_STEPS} steps")
    gan = make_gan(c, device)
    gan.init_state(torch.Generator().manual_seed(SEED))
    data_gen = torch.Generator(device=device).manual_seed(SEED + 2)
    ctx_len = c["seq_length"] + 2 * c["temporal_context"]

    def synthetic_batches():
        """Seeded videos made on the card: smooth random fields in [-1, 1]."""
        while True:
            batch = {}
            for key, (h, w) in (("lr_video", (36, 64)), ("hr_video", (144, 256))):
                coarse = torch.rand((TRAIN_BATCH, 3, ctx_len, 9, 16), generator=data_gen,
                                    device=device) * 2 - 1
                batch[key] = torch.nn.functional.interpolate(
                    coarse, size=(ctx_len, h, w), mode="trilinear", align_corners=False)
            yield batch

    batches = synthetic_batches()
    snapshot = {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
                for name, m in (("G", gan.G), ("D", gan.D), ("G_ema", gan.G_ema))}
    train_gen = torch.Generator(device=device).manual_seed(SEED + 3)
    collector = Collector()
    torch.cuda.reset_peak_memory_stats()
    # Record the shape of every kernel output in training, to hold it to the
    # shapes checked above.
    seen = {"filtered_lrelu_fwd_cuda": set(), "filtered_lrelu_bwd_cuda": set()}

    def recording(fn, shapes):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            shapes.add(tuple(out.shape))
            return out
        return wrapped

    wrappers = {key: getattr(filtered_lrelu_cuda, key) for key in seen}
    for key, fn in wrappers.items():
        setattr(filtered_lrelu_cuda, key, recording(fn, seen[key]))
    filtered_lrelu_cuda.launches = filtered_lrelu_cuda.bwd_launches = 0
    step_s = []
    try:
        for step in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for stats in train_step(gan, train_gen, c, step, batches):
                collector.report(stats)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
    finally:
        for key, fn in wrappers.items():
            setattr(filtered_lrelu_cuda, key, fn)
    train_launches = filtered_lrelu_cuda.launches
    train_bwd_launches = filtered_lrelu_cuda.bwd_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    collector.update()
    n_layers = len(selftest.KERNEL_LAYERS)
    want_k1 = TRAIN_STEPS * n_layers * (c["gan_kwargs"]["G_grad_accum"]
                                        + c["gan_kwargs"]["D_grad_accum"])
    want_k2 = TRAIN_STEPS * n_layers * c["gan_kwargs"]["G_grad_accum"]
    losses = {k: collector.mean(k) for k in ("loss/G_loss", "loss/D_loss", "loss/r1_loss",
                                             "loss/r1_penalty", "progress/augment_p")}
    print("losses " + ", ".join(f"{k} {v:.5g}" for k, v in losses.items()))
    print(f"step seconds {', '.join(f'{s:.3f}' for s in step_s)} (step 0 runs R1 and ADA); "
          f"warm sec/step (steps 1-{TRAIN_STEPS - 1}) "
          f"{sum(step_s[1:]) / (TRAIN_STEPS - 1):.3f}; peak memory {peak_gib:.2f} GiB")
    print(f"K1 launches {train_launches} (expected {want_k1}), "
          f"K2 launches {train_bwd_launches} (expected {want_k2})")
    if not all(math.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"non-finite training statistics: {losses}")
    if train_launches != want_k1 or train_bwd_launches != want_k2:
        raise RuntimeError("training launched the kernels other than its micro-batches imply")
    for key, (checks, _, _) in (("filtered_lrelu_fwd_cuda", fwd[train_frames]),
                                ("filtered_lrelu_bwd_cuda", bwd)):
        checked = {k.shape for k in checks if k.dtype == "bfloat16"}
        if seen[key] != checked:
            raise RuntimeError(f"training ran {key} at {sorted(seen[key] - checked)}, "
                               f"shapes not checked against its plain version")
    print(f"training ran K1 and K2 at the {train_frames}-frame shapes checked above")
    for name, module in (("G", gan.G), ("D", gan.D), ("G_ema", gan.G_ema)):
        params = [k for k, _ in module.named_parameters()]
        state = module.state_dict()
        if all(torch.equal(snapshot[name][k], state[k]) for k in params):
            raise RuntimeError(f"training left {name} unchanged")
    print("G, D and G_ema changed")

    # 8. A G micro-batch's parameter gradients: auto (K1/K2) vs conv (plain).
    phase(f"gradient check: one G micro-batch ({GRAD_CLIPS} clips), auto vs conv, TF32 off")
    plain_gan = make_gan({**c, "gan_kwargs": {**c["gan_kwargs"], "G_kwargs": {
        **c["gan_kwargs"]["G_kwargs"], "resample_impl": "conv"}}}, device)
    plain_gan.G.load_state_dict(gan.G.state_dict())
    plain_gan.D.load_state_dict(gan.D.state_dict())
    plain_gan.ada_p = gan.ada_p.clone()
    lr_chunk = next(batches)["lr_video"][:GRAD_CLIPS]
    z = torch.randn((GRAD_CLIPS, gan.G.latent_z_dim), generator=train_gen, device=device)
    grads = []
    filtered_lrelu_cuda.launches = filtered_lrelu_cuda.bwd_launches = 0
    with selftest.tf32_off():
        for trainer in (gan, plain_gan):
            trainer.D.requires_grad_(False)
            loss, _ = trainer.G_micro_loss(torch.Generator(device=device).manual_seed(SEED + 4),
                                           lr_chunk, z=z)
            params = list(trainer.G.parameters())
            g = torch.autograd.grad(loss, params, allow_unused=True)
            grads.append(torch.cat([(t if t is not None else torch.zeros_like(p)).flatten()
                                    .float() for t, p in zip(g, params)]))
    if filtered_lrelu_cuda.bwd_launches != n_layers:
        raise RuntimeError("the auto gradient did not run through K2")
    grad_err = rel_err(grads[0], grads[1])
    print(f"G gradient rel_err {grad_err:.3e} over {grads[0].numel()} parameters "
          f"(tol {GRAD_TOL})")
    if not math.isfinite(grad_err) or grad_err > GRAD_TOL:
        raise RuntimeError(f"auto vs plain G gradient rel_err {grad_err} > {GRAD_TOL}")
    del plain_gan, grads

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

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax",
                                                                   "long_video_gan_tpu"))
    if leaked:
        raise RuntimeError(f"the port imported the JAX side: {leaked[:5]}")

    _, kernel_ms, plain_ms = fwd[train_frames]
    bwd_checks, bwd_ms, bwd_plain_ms = bwd
    print(json.dumps({"kernels": [
        {
            "name": "filtered_lrelu_fwd",
            "route": "cuda",
            "source": filtered_lrelu_cuda.SOURCE,
            "replaces": "long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py:212",
            "launches": gen_launches + train_launches,
            "launches_by_path": {"generate": gen_launches, "train": train_launches},
            "max_abs_err": max(k.max_abs_err for checks, _, _ in fwd.values() for k in checks),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "ms_by_path": {"generate": fwd[SEGMENT][1:], "train": fwd[train_frames][1:]},
        },
        {
            "name": "filtered_lrelu_bwd",
            "route": "cuda",
            "source": filtered_lrelu_cuda.BWD_SOURCE,
            "replaces": "long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py:305",
            "launches": train_bwd_launches,
            "launches_by_path": {"generate": 0, "train": train_bwd_launches},
            "max_abs_err": max(k.max_abs_err for k in bwd_checks),
            "ms": bwd_ms,
            "plain_ms": bwd_plain_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def check_kernel(check, layers, frames: int, device, gen, kernel: str):
    """`check` (a selftest layer check) at every bf16 layer that launches the
    kernel, timed, and at L0 and L3 in f32; raises if any disagrees. Returns
    (the checks, kernel ms, plain ms summed over L3-L13)."""
    import torch

    from long_video_gan_tpu_torch import selftest

    checks = [check(layers[i][1], layers[i][0], frames, torch.bfloat16, device, gen,
                    time_it=True) for i in selftest.KERNEL_LAYERS]
    checks += [check(layers[i][1], layers[i][0], frames, torch.float32, device, gen)
               for i in (0, 3)]
    kernel_ms, plain_ms = report_checks(checks, selftest.TOLS, kernel)
    print(f"{kernel} L3-L13 at {frames} frames: kernel {kernel_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms")
    return checks, kernel_ms, plain_ms


def report_checks(checks, tols, kernel: str) -> tuple[float, float]:
    """Print each layer check; raise if any failed; (kernel ms, plain ms)
    summed over the timed checks."""
    import torch

    for c in checks:
        timing = "" if c.ms is None else f" kernel {c.ms:.3f} ms plain {c.plain_ms:.3f} ms"
        print(f"{kernel} {c.name:<16} {c.dtype:<8} out {c.shape} rel_err {c.rel_err:.2e} "
              f"(tol {tols[getattr(torch, c.dtype)]:g}){timing} {'ok' if c.ok else 'FAIL'}")
    failed = [c.name + "/" + c.dtype for c in checks if not c.ok]
    if failed:
        raise RuntimeError(f"{kernel} disagrees with its plain version at {failed}")
    timed = [c for c in checks if c.ms is not None]
    return sum(c.ms for c in timed), sum(c.plain_ms for c in timed)


if __name__ == "__main__":
    sys.exit(main())
