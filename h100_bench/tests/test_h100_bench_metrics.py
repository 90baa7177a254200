"""The yardstick's arithmetic on synthetic inputs: a chrome trace's busy
union and category sums, the per-layer readers' shares, the copied
operation counts, and the shape of the result line."""

import json
import math

import pytest
import torch

from h100_bench import flops
from h100_bench import run as bench_run
from h100_bench.reference.sres_generator import VideoGenerator as RefGenerator
from h100_bench.trace import Trace, categorize, read_chrome_trace
from h100_bench.tests.helpers import run_tiny

EVENTS = [
    # name, start us, duration us
    ("void filtered_lrelu_fwd_tc_kernel<16>(Params)", 0.0, 100.0),
    ("void at::native::conv_depthwise2d_forward_kernel<float>", 50.0, 100.0),   # overlaps
    ("sm90_xmma_fprop_implicit_gemm_bf16", 300.0, 200.0),
    ("Memcpy DtoH (Device -> Pageable)", 600.0, 50.0),
    ("void filtered_lrelu_bwd_tc_kernel<16>(Params)", 700.0, 100.0),
]


def synthetic_trace(tmp_path, window_s=0.001):
    events = [{"ph": "X", "cat": "kernel" if "Memcpy" not in n else "gpu_memcpy",
               "name": n, "ts": ts, "dur": dur} for n, ts, dur in EVENTS]
    events.append({"ph": "X", "cat": "user_annotation", "name": "bench.update_G", "ts": 0.0,
                   "dur": 1000.0})
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0.0, "dur": 5.0})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(str(path), window_s)


def test_busy_is_the_union_of_device_intervals(tmp_path):
    tr = synthetic_trace(tmp_path)
    # [0, 150] + [300, 500] + [600, 650] + [700, 800] us.
    assert tr.busy_s() == pytest.approx(500e-6)
    idle = bench_run.metric_reader("idle_share.gen")({"trace": tr})
    assert idle == pytest.approx(50.0)


def test_category_sums_and_names(tmp_path):
    tr = synthetic_trace(tmp_path)
    by = tr.seconds_by(categorize)
    assert by["K1 filtered_lrelu fwd"] == pytest.approx(100e-6)
    assert by["K2 filtered_lrelu bwd"] == pytest.approx(100e-6)
    assert by["depthwise conv"] == pytest.approx(100e-6)
    assert by["conv (cuDNN/CUTLASS)"] == pytest.approx(200e-6)
    assert by["memcpy/memset"] == pytest.approx(50e-6)
    ctx = {"trace": tr, "steps": 2}
    assert bench_run.metric_reader("fir_ms.train")(ctx) == pytest.approx(0.05)
    assert bench_run.metric_reader("conv_ms.train")(ctx) == pytest.approx(0.1)
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps[0] == ["bench.update_G", pytest.approx(150e-6)]


def test_roofline_shares_and_silence(tmp_path):
    tr = synthetic_trace(tmp_path)
    ctx = {"trace": tr, "k1_bound_s": 25e-6, "k1_launches": 11, "k1_expected": 11,
           "k2_bound_s": 10e-6, "k2_launches": 22, "k2_expected": 22}
    assert bench_run.metric_reader("k1_roofline")(ctx) == pytest.approx(25.0)
    assert bench_run.metric_reader("k2_roofline")(ctx) == pytest.approx(10.0)
    # A kernel off its path reports nothing, never 0.
    assert bench_run.metric_reader("k1_roofline")(dict(ctx, k1_launches=0)) is None
    empty = Trace([], 0.001)
    assert bench_run.metric_reader("k2_roofline")(dict(ctx, trace=empty)) is None
    assert bench_run.metric_reader("idle_share.train")({"trace": empty}) is None


def test_mfu_readers(tmp_path):
    tr = synthetic_trace(tmp_path, window_s=2.0)
    ctx = {"trace": tr, "frames": 10, "flops": 989e12, "host_s": 2.0, "steps": 1}
    assert bench_run.metric_reader("mfu.gen")(ctx) == pytest.approx(50.0)
    assert bench_run.metric_reader("mfu.train")(ctx) == pytest.approx(50.0)
    assert bench_run.metric_reader("mfu.gen")(dict(ctx, frames=0)) is None


def test_flops_per_frame_equals_the_program_bench():
    from long_video_gan_tpu_torch import bench

    ours = flops.flops_per_frame(RefGenerator(**bench.CONFIG), 16)
    theirs = bench.flops_per_frame(bench.make_generator("auto", "cpu"), 16)
    assert ours == theirs
    assert ours == pytest.approx(0.32337e12, rel=1e-4)


def test_hand_kernel_bound_equals_selftest():
    from long_video_gan_tpu_torch import selftest

    ref = RefGenerator(**{**selftest_config(), "num_fp16_res": 4})
    plan = dict(selftest.plan_layers())
    for layer, (name, prog) in zip(flops.hand_kernel_layers(ref), sorted(
            ((n, l) for n, l in plan.items() if l.use_fp16), key=lambda p: int(p[0][1:3].strip("_")))):
        for backward in (False, True):
            ms, _ = selftest.bound(prog, 16, torch.bfloat16, backward)
            assert flops.bound_s(layer, 16, torch.bfloat16, backward) * 1e3 == pytest.approx(ms)


def selftest_config():
    return dict(hr_height=144, hr_width=256, lr_height=36, lr_width=64, temporal_context=4)


def test_training_flops_counted_on_meta():
    """Dense operations of a tiny cycle: forward plus both gradients of
    every dense conv and product, R1's double backward on top; a cycle is
    its micro-batches' sum."""
    from h100_bench.drivers import train
    from h100_bench.tests.helpers import tiny_cell

    _, config, traffic = tiny_cell("sres-train")
    driver = train.Driver(type("R", (), dict(config=config, traffic=traffic, seed=1,
                                            device=torch.device("cpu")))())
    driver.pool = driver._pool()
    with_r1 = driver._step_flops(0, flops)
    without = driver._step_flops(1, flops)
    assert with_r1 > without > 0
    whole = dict(config["gan"], G_grad_accum=1, D_grad_accum=1)
    driver.kwargs = whole
    assert driver._step_flops(1, flops) == without


def test_result_line_shape():
    result = run_tiny("sres-stream")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checked"
    assert set(result["metrics"]) == {"gen_frames_per_s", "segment_ms_p95", "peak_mem_gib",
                                      "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in result["checked"].values():
        assert set(c) == {"value", "limit"}
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    json.dumps(result)
