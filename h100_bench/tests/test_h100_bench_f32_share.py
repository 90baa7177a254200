"""The f32 filtered_lrelu kernels' share of the traced device busy time
(`metrics/flrelu_f32_share.{gen,train}.py`) on synthetic traces: nothing
without such a kernel, the share of busy time with one, and neither K1/K2
nor the depthwise convolutions counted in it."""

import pytest

from h100_bench import run as bench_run
from h100_bench.trace import Trace, categorize

NAMES = ("flrelu_f32_share.gen", "flrelu_f32_share.train")
OTHERS = [
    # name, start us, duration us
    ("void filtered_lrelu_fwd_tc_kernel<16>(Params)", 0.0, 100.0),
    ("void filtered_lrelu_bwd_tc_kernel<16>(Params)", 100.0, 100.0),
    ("void at::native::conv_depthwise2d_forward_kernel<float>", 200.0, 100.0),
]
F32 = [
    ("(anonymous namespace)::flrelu_f32_fwd_kernel(float const*, float*, float const*, "
     "(anonymous namespace)::Geometry)", 300.0, 50.0),
    ("(anonymous namespace)::flrelu_f32_bwd_kernel(float const*, float const*, float*, "
     "float const*, (anonymous namespace)::Geometry)", 350.0, 30.0),
]


@pytest.mark.parametrize("name", NAMES)
def test_nothing_without_an_f32_kernel(name):
    assert bench_run.metric_reader(name)({"trace": Trace(OTHERS, 0.001)}) is None
    assert bench_run.metric_reader(name)({"trace": Trace([], 0.001)}) is None


@pytest.mark.parametrize("name", NAMES)
def test_share_of_busy_time(name):
    # Busy: [0, 380] us; the f32 kernels' own time 50 + 30 us.
    tr = Trace(OTHERS + F32, 0.001)
    assert tr.busy_s() == pytest.approx(380e-6)
    assert bench_run.metric_reader(name)({"trace": tr}) == pytest.approx(100.0 * 80 / 380)


@pytest.mark.parametrize("name", NAMES)
def test_k1_k2_and_depthwise_do_not_count(name):
    """K1/K2 and the depthwise FIRs keep their categories, and the f32
    kernels fall in none of them ("other"): adding those events moves the
    share only through the busy time."""
    for event in F32:
        assert categorize(event[0]) == "other"
    assert {categorize(e[0]) for e in OTHERS} == {
        "K1 filtered_lrelu fwd", "K2 filtered_lrelu bwd", "depthwise conv"}
    assert bench_run.metric_reader(name)({"trace": Trace(F32, 0.001)}) == pytest.approx(100.0)
