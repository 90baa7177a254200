"""The port's sres synthesis bench (`long_video_gan_tpu_torch/bench.py`) on the
CPU: its weights against the JAX bench's fill (`bench.py:136-149`) array for
array at full width, a segment from those weights through the JAX
`VideoGenerator` and the port at a tiny width, the FLOP count (the same for
every impl; its dense part against `FlopCounterMode`), the guard's
impl -> kernel -> layer map, the timing protocol and the model check on the
CPU's plain versions, and the CLI without CUDA."""

import dataclasses
import io
import json
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch import bench, selftest
from long_video_gan_tpu_torch.io.convert_torch import flatten_variables, module_to_variables
from long_video_gan_tpu_torch.models import generator_sres
from test_torch_generators import RTOL, SRES_KW

# The tiny sres geometry in f32 (bf16 layers would hold the port's plain K1
# to the JAX composed path at bf16's precision, not the full-model bar).
TINY = {**SRES_KW, "num_fp16_res": 0}
TINY_SEGMENT = 4


def jax_bench_fill(G, lr_shape, seed=0):
    """The JAX bench's variables: its `fill` over `jax.eval_shape` of G's
    init (bench.py:136-149), then its lr video and z (:177-179) from the
    same generator."""
    shapes = jax.eval_shape(
        lambda: G.init({"params": jax.random.key(0), "noise": jax.random.key(1)},
                       jnp.zeros(lr_shape, jnp.float32)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if "ema" in name or "magnitude" in name:
            return np.ones(s.shape, s.dtype)
        if np.issubdtype(s.dtype, np.floating):
            return (rng.standard_normal(s.shape) * 0.1).astype(s.dtype)
        return np.zeros(s.shape, s.dtype)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    lr_video = rng.standard_normal(lr_shape).astype(np.float32) * 0.2
    z = rng.standard_normal((lr_shape[0], G.latent_z_dim)).astype(np.float32)
    return variables, lr_video, z


def test_fill_variables_is_the_jax_bench_fill():
    """At the bench configuration: every array of the port's G after
    `fill_variables` equals the JAX bench's, and the inputs drawn next equal
    the JAX bench's lr video and z."""
    segment = 16
    G = jax_sres.VideoGenerator(**bench.CONFIG, resample_impl="auto")
    lr_shape = (1, 3, segment + 2 * bench.CONFIG["temporal_context"], 36, 64)
    variables, lr_want, z_want = jax_bench_fill(G, lr_shape)
    port = bench.make_generator("auto", "cpu")
    rng = bench.fill_variables(port, seed=0)
    lr, z = bench.make_inputs(port, rng, batch=1, segment=segment)
    want = flatten_variables(variables)
    got = flatten_variables(module_to_variables(port))
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert {k for k, v in got.items() if np.all(v == 1)} >= {
        k for k in got if "magnitude" in k or k.endswith("w_avg")}
    np.testing.assert_array_equal(lr.numpy(), lr_want)
    np.testing.assert_array_equal(z.numpy(), z_want)


@pytest.mark.parametrize("impl", ["conv", "packed"])
def test_segment_matches_jax(impl):
    """One segment from the bench's weights and inputs: JAX `G.apply` on
    "matrix" against the port on `impl` (the plain versions on the CPU)."""
    G = jax_sres.VideoGenerator(**TINY, resample_impl="matrix")
    lr_shape = (1, 3, TINY_SEGMENT + 2 * TINY["temporal_context"], TINY["lr_height"],
                TINY["lr_width"])
    variables, lr_video, z = jax_bench_fill(G, lr_shape, seed=3)
    want = np.asarray(G.apply(variables, jnp.asarray(lr_video), z=jnp.asarray(z)))
    port = bench.make_generator(impl, "cpu", **TINY)
    lr, zt = bench.make_inputs(port, bench.fill_variables(port, seed=3), segment=TINY_SEGMENT)
    with torch.no_grad():
        got = port(lr, z=zt).numpy()
    assert got.shape == want.shape == (1, 3, TINY_SEGMENT, TINY["hr_height"], TINY["hr_width"])
    assert np.ptp(want) > 0.01
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_flops_per_frame_is_the_same_for_every_impl():
    counts = {impl: bench.segment_flops(bench.make_generator(impl, "meta"))
              for impl in bench.IMPLS}
    assert all(c == counts["auto"] for c in counts.values())
    per_frame = {impl: bench.flops_per_frame(bench.make_generator(impl, "meta"))
                 for impl in bench.IMPLS}
    assert len(set(per_frame.values())) == 1
    # Each filtered_lrelu's part is the count selftest.bound prices.
    layers = selftest.plan_layers()
    fir = sum(2 * selftest.filtered_lrelu_macs(layer)[2] * layer.out_channels * 16
              for _, layer in layers)
    assert 0 < counts["auto"]["fir"] - fir < 0.01 * fir   # + the Kaiser resamplers


def _uncounted(fn):
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    return run


@pytest.mark.parametrize("fourfeats,batch", [(False, 1), (True, 2)])
def test_dense_flops_match_flop_counter(monkeypatch, fourfeats, batch):
    """`segment_flops`' conv and matmul parts equal FlopCounterMode's count
    of a forward on the CPU with the FIR work (filtered_lrelu and the
    conditioning resamplers, which `fir` counts tap-exact) left uncounted."""
    G = bench.make_generator("conv", "cpu", **{**TINY, "fourfeats": fourfeats})
    lr, z = bench.make_inputs(G, bench.fill_variables(G), batch=batch, segment=TINY_SEGMENT)
    for name in ("filtered_lrelu", "upsample2d", "downsample2d"):
        monkeypatch.setattr(generator_sres, name, _uncounted(getattr(generator_sres, name)))
    with torch.no_grad(), FlopCounterMode(display=False) as mode:
        G(lr, z=z)
    by_op = {str(op): n for op, n in mode.get_flop_counts()["Global"].items()}
    want = bench.segment_flops(G, TINY_SEGMENT, batch)
    assert by_op.pop("aten.convolution") == want["conv"]
    assert set(by_op) <= {"aten.mm", "aten.bmm", "aten.addmm"}
    assert sum(by_op.values()) == want["matmul"]
    assert mode.get_total_flops() == want["conv"] + want["matmul"]


def test_resampler_macs_give_the_forward_shapes():
    G = bench.make_generator("conv", "cpu")
    edge = 64 + 2 * G.SG3.margin_size
    resamplers = [r for r in G.SG3.resamplers.values()
                  if not isinstance(r, torch.nn.Identity)]
    assert len(resamplers) == 4
    for r in resamplers:
        h, w, macs = r.macs(edge, edge - 3)
        assert tuple(r(torch.zeros(1, 1, edge, edge - 3)).shape[2:]) == (h, w)
        assert macs > 0


def test_guard_map():
    """auto and packed guard K1, fused K3a, at L3 (31x38 conv input, up 4,
    bf16), and auto and packed also K1f32 at L0 (f32); pallas K4 at L4,
    since K4 cannot take L3's crop; conv and matrix run no kernel."""
    assert bench.GUARD == {"auto": (("K1", 3), ("K1f32", 0)),
                           "packed": (("K1", 3), ("K1f32", 0)),
                           "fused": (("K3a", 3),), "pallas": (("K4", 4),)}
    assert set(bench.IMPLS) - set(bench.GUARD) == {"conv", "matrix"}
    layers = selftest.plan_layers()
    _, l3 = layers[3]
    assert (l3.in_size[1] + l3.kernel - 1, l3.in_size[0] + l3.kernel - 1) == (31, 38)
    assert l3.up_factor == 4 and selftest.layer_dtype(l3) == torch.bfloat16
    assert selftest.layer_dtype(layers[0][1]) == torch.float32
    for checks in bench.GUARD.values():
        for kernel, index in checks:
            assert index in selftest.served_layers(kernel, layers)
    assert 3 not in selftest.served_layers("K4", layers)


@pytest.mark.parametrize("impl", bench.IMPLS)
def test_guard_writes_only_to_its_log(impl, capsys):
    log = io.StringIO()
    assert bench.guard(impl, torch.device("cpu"), frames=1, log=log)
    assert capsys.readouterr().out == ""
    kernels = [kernel for kernel, _ in bench.GUARD.get(impl, (("runs no kernel", None),))]
    lines = log.getvalue().splitlines()
    assert len(lines) == len(kernels) == log.getvalue().count("\n")
    for line, kernel in zip(lines, kernels):
        assert kernel in line


@pytest.mark.parametrize("impl", ("auto", "packed"))
def test_guard_checks_the_f32_kernel_too(impl, monkeypatch):
    """auto and packed time K1 and K1f32, so the guard runs both checks, the
    second on the f32 head L0 through K1's entry (the wrapper picks the f32
    kernel by dtype), and fails if either does."""
    seen = []
    real = selftest.check_layer

    def check_layer(layer, name, frames, dtype, *args, kernel, **kw):
        seen.append((name, dtype, kernel))
        check = real(layer, name, frames, dtype, *args, kernel=kernel, **kw)
        return dataclasses.replace(check, ok=check.ok and dtype != torch.float32)

    monkeypatch.setattr(selftest, "check_layer", check_layer)
    layers = selftest.plan_layers()
    assert not bench.guard(impl, torch.device("cpu"), frames=1, log=io.StringIO())
    assert seen == [(layers[3][0], torch.bfloat16, "K1"), (layers[0][0], torch.float32, "K1")]


def test_measure_and_model_selftest_on_the_cpu():
    """The two protocols on the CPU's plain versions at a tiny width
    (finite rates, no kernel launched), and the model check passing."""
    G = bench.make_generator("auto", "cpu", **TINY)
    lr, z = bench.make_inputs(G, bench.fill_variables(G), segment=TINY_SEGMENT)
    timed = bench.measure(G, lr, z, chain=2, iters=1, warmup=1)
    assert math.isfinite(timed["value"]) and timed["value"] > 0
    assert math.isfinite(timed["per_segment_value"]) and timed["per_segment_value"] > 0
    assert timed["launches"] == {"K1": 0, "K1f32": 0, "K3a": 0, "K4": 0}
    log = io.StringIO()
    assert bench.run_model_selftest(torch.device("cpu"), segment=TINY_SEGMENT, log=log, **TINY)
    assert log.getvalue().count("ok") == len(bench.MODEL_IMPLS)


def test_main_without_cuda_prints_one_null_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    out = capsys.readouterr().out
    assert out.count("\n") == 1
    record = json.loads(out)
    assert record["value"] is None and record["error"] == "no-cuda-device"
    assert record["metric"] == bench.METRIC

