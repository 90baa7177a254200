"""Reading the program's spans out of a chrome trace, on synthetic traces:
which spans own a device event (across two threads, nesting, unmatched
launches), each reading's silence rule, launch waits within the idle time,
and the accepted readers and breakdown unchanged by the program's spans and
the launch events a trace now carries."""

import json

import pytest

from h100_bench import run as bench_run
from h100_bench import spans
from h100_bench.trace import read_chrome_trace

MAIN, AUTOGRAD, STREAM = 1, 2, 7


def span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": tid}


def launch(corr, ts, tid=MAIN):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2.0,
            "pid": 0, "tid": tid, "args": {"correlation": corr}}


def kernel(name, corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": STREAM, "args": {"correlation": corr, "stream": STREAM}}


# A training phase: G's forward on the main thread (a composed filtered_lrelu
# whose upfirdn2d runs inside it, and a conditioning FIR), its backward on
# autograd's thread, a K1 launch through the driver API, an event whose
# launch is missing, and a bench span around all.
PHASE = [
    span("bench.update_G", 0.0, 2000.0),
    span("lvg.update_G", 0.0, 2000.0),
    span("lvg.G", 10.0, 400.0),
    span("lvg.prep_cond", 20.0, 80.0),
    span("lvg.upfirdn2d.conv", 30.0, 20.0),
    span("lvg.layer.L3_36_36_512", 120.0, 200.0),
    span("lvg.filtered_lrelu.composed", 130.0, 100.0),
    span("lvg.upfirdn2d.conv", 140.0, 20.0),
    span("lvg.layer.L4_36_36_512", 330.0, 70.0),
    span("lvg.filtered_lrelu.packed", 340.0, 50.0),
    span("lvg.D", 500.0, 600.0),
    span("lvg.filtered_lrelu.composed.bwd", 600.0, 100.0, AUTOGRAD),
    span("lvg.upfirdn2d.conv.bwd", 610.0, 80.0, AUTOGRAD),
    launch(1, 35.0), kernel("conv_depthwise2d_forward_kernel", 1, 40.0, 100.0),
    launch(2, 145.0), kernel("conv_depthwise2d_forward_kernel", 2, 150.0, 30.0),
    launch(3, 200.0), kernel("elementwise_kernel", 3, 205.0, 10.0),
    {**launch(4, 350.0), "cat": "cuda_driver", "name": "cuLaunchKernel"},
    kernel("filtered_lrelu_fwd_tc_kernel", 4, 360.0, 200.0),
    # Launched on autograd's thread while lvg.D is open on the main thread.
    launch(5, 620.0, AUTOGRAD), kernel("conv_depthwise2d_forward_kernel", 5, 700.0, 50.0),
    kernel("Memcpy HtoD (Pageable -> Device)", 99, 800.0, 10.0, cat="gpu_memcpy"),
    # Launched before the gap it closes opened: a wait on the device, not
    # on the host.
    launch(6, 805.0), kernel("elementwise_kernel", 6, 900.0, 20.0),
    launch(7, 1150.0), kernel("elementwise_kernel", 7, 1200.0, 10.0),
    {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 0.0, "dur": 5.0, "pid": 0,
     "tid": MAIN},
    {"ph": "X", "cat": "gpu_user_annotation", "name": "lvg.G", "ts": 40.0, "dur": 500.0,
     "pid": 1, "tid": STREAM},
]


def write(tmp_path, events, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


@pytest.fixture
def st(tmp_path):
    return spans.read_spans(write(tmp_path, PHASE))


def owners(st, corr):
    i = next(i for i, e in enumerate(st.events) if e.correlation == corr)
    return None if st.owners[i] is None else sorted(st.names_of(i))


def test_attribution_across_two_threads(st):
    assert owners(st, 1) == ["lvg.G", "lvg.prep_cond", "lvg.update_G", "lvg.upfirdn2d.conv"]
    assert owners(st, 4) == ["lvg.G", "lvg.filtered_lrelu.packed", "lvg.layer.L4_36_36_512",
                             "lvg.update_G"]
    # Autograd's launch: its own thread's spans and the phase, not lvg.D.
    assert owners(st, 5) == ["lvg.filtered_lrelu.composed.bwd", "lvg.update_G",
                             "lvg.upfirdn2d.conv.bwd"]
    assert owners(st, 7) == ["lvg.update_G"]
    # The device-side copies of spans are not device work.
    assert all(e.name != "lvg.G" for e in st.events)
    assert st.device_s() == pytest.approx(430e-6)


def test_nesting_and_unmatched_launches(st):
    # The conditioning FIR counts; the one inside the composed filtered_lrelu
    # (forward and backward) counts to the filtered_lrelu.
    assert spans.upfirdn2d_s(st) == pytest.approx(100e-6)
    seconds, calls = spans.filtered_lrelu_s(st, ["L3_36_36_512", "L4_36_36_512"])
    assert seconds == pytest.approx(240e-6) and calls == 2
    seconds, calls = spans.filtered_lrelu_s(st, ["L4_36_36_512"])
    assert seconds == pytest.approx(200e-6) and calls == 1
    assert owners(st, 99) is None
    assert st.unmatched_s() == pytest.approx(10e-6)
    assert spans.fir_sites(st) == {"fwd lvg.prep_cond in lvg.update_G": pytest.approx(100e-6)}
    out = spans.report(st)
    assert out["unmatched_share"] == pytest.approx(10 / 430)
    assert out["filtered_lrelu_ms_by_span"] == {
        "lvg.filtered_lrelu.composed": pytest.approx(0.04),
        "lvg.filtered_lrelu.composed.bwd": pytest.approx(0.05),
        "lvg.filtered_lrelu.packed": pytest.approx(0.2)}
    assert out["depthwise_ms_by_op"] == {"lvg.upfirdn2d.conv": pytest.approx(0.1),
                                         "lvg.filtered_lrelu.composed": pytest.approx(0.03),
                                         "lvg.filtered_lrelu.composed.bwd": pytest.approx(0.05)}


def test_launch_waits_within_the_idle_time(st):
    # Busy runs: [40, 140], [150, 180], [205, 215], [360, 560], [700, 750],
    # [800, 810], [900, 920], [1200, 1210]. The gaps closed at 150, 205 and
    # 360 are waits (each launched after the gap opened); 700 was launched at
    # 620 > 560 too; 800 is unmatched; 900 was launched at 805 < 810; 1200
    # at 1150 > 920, after lvg.D closed.
    waits = spans.launch_waits(st)
    assert [round(s * 1e6, 6) for s, _ in waits] == [10.0, 25.0, 145.0, 140.0, 280.0]
    assert [w for _, w in waits] == ["lvg.upfirdn2d.conv", "lvg.filtered_lrelu.composed",
                                     "lvg.filtered_lrelu.packed", "lvg.upfirdn2d.conv.bwd",
                                     "lvg.update_G"]
    idle = spans.idle_between_s(st)
    assert idle == pytest.approx(740e-6)
    assert sum(s for s, _ in waits) <= idle
    out = spans.readings(st, "train", {"steps": 2}, [])
    assert out["launch_wait_ms.train"] == pytest.approx(0.3)
    assert out["upfirdn2d_ms.train"] == pytest.approx(0.05)


def test_update_r1_is_the_union_of_its_device_intervals(tmp_path):
    events = [span("lvg.update_r1", 0.0, 1000.0), span("lvg.update_r1", 2000.0, 1000.0),
              span("lvg.update_D", 1000.0, 1000.0),
              launch(1, 10.0), kernel("a", 1, 20.0, 100.0),
              launch(2, 15.0), {**kernel("b", 2, 50.0, 100.0), "tid": 8},   # overlaps
              launch(3, 2010.0, AUTOGRAD), kernel("c", 3, 2100.0, 40.0),
              launch(4, 1500.0), kernel("d", 4, 1600.0, 300.0)]
    st = spans.read_spans(write(tmp_path, events))
    out = spans.readings(st, "train", {"steps": 1}, [])
    assert out["update_r1_device_ms.train"] == pytest.approx((130.0 + 40.0) / 2 / 1e3)
    # A late launch on a thread with no span open is named by its phase.
    assert spans.launch_waits(st) == [(pytest.approx(1450e-6), "lvg.update_D"),
                                      (pytest.approx(200e-6), "- in lvg.update_r1")]


def test_silence(tmp_path, st):
    no_spans = [e for e in PHASE if not e["name"].startswith("lvg.")]
    quiet = spans.read_spans(write(tmp_path, no_spans, "quiet.json"))
    assert spans.readings(quiet, "stream", {"k1_bound_s": 1.0, "k1_expected": 1}, []) == {}
    assert spans.readings(quiet, "train", {"steps": 1}, []) == {}
    cpu_only = spans.read_spans(write(tmp_path, [e for e in PHASE if e.get("pid") == 0],
                                      "cpu.json"))
    assert spans.readings(cpu_only, "train", {"steps": 1}, []) == {}
    # No R1 in the window: no R1 reading.
    assert spans.readings(st, "train", {"steps": 1}, [])["update_r1_device_ms.train"] is None
    # The roofline reads only when the kernel layers' calls are as many as
    # the cell expects; no segment span, no per-segment reading.
    layers = ["L3_36_36_512", "L4_36_36_512"]
    out = spans.readings(st, "stream", {"k1_bound_s": 24e-6, "k1_expected": 2}, layers)
    assert out == {"upfirdn2d_ms.gen": None, "filtered_lrelu_roofline.gen": pytest.approx(10.0),
                   "launch_wait_ms.gen": None}
    out = spans.readings(st, "stream", {"k1_bound_s": 24e-6, "k1_expected": 22}, layers)
    assert out["filtered_lrelu_roofline.gen"] is None


def test_stream_readings_per_segment(tmp_path):
    events = [span("lvg.segment", 0.0, 100.0), span("lvg.segment", 200.0, 100.0),
              span("lvg.prep_cond", 210.0, 20.0), span("lvg.upfirdn2d.conv", 212.0, 10.0),
              launch(1, 215.0), kernel("conv_depthwise2d_forward_kernel", 1, 220.0, 60.0),
              launch(2, 10.0), kernel("x", 2, 20.0, 100.0)]
    st = spans.read_spans(write(tmp_path, events))
    out = spans.readings(st, "stream", {"k1_bound_s": 1.0, "k1_expected": 0}, [])
    assert out["upfirdn2d_ms.gen"] == pytest.approx(0.03)
    # The gap [120, 220] closed by a launch at 215.
    assert out["launch_wait_ms.gen"] == pytest.approx(0.05)


def test_accepted_readers_unchanged_by_program_spans(tmp_path):
    """The accepted trace reader, its breakdown and every accepted reader
    give the same numbers on a trace with the program's spans and launch
    events as on the same trace without them."""
    bare = [{k: v for k, v in e.items() if k != "args"} for e in PHASE
            if e["cat"] in ("kernel", "gpu_memcpy")
            or (e["cat"] == "user_annotation" and e["name"].startswith("bench."))]
    full = read_chrome_trace(write(tmp_path, PHASE, "full.json"), 0.002)
    plain = read_chrome_trace(write(tmp_path, bare, "bare.json"), 0.002)
    assert full.events == plain.events and full.host_spans == plain.host_spans
    assert full.busy_s() == plain.busy_s()
    assert full.breakdown() == plain.breakdown()
    assert full.breakdown()["idle_gaps"][0] == ["bench.update_G", pytest.approx(280e-6)]
    ctx = {"steps": 2, "k1_bound_s": 20e-6, "k1_launches": 1, "k1_expected": 1,
           "k2_bound_s": 1e-6, "k2_launches": 0, "k2_expected": 0}
    names = ("fir_ms.train", "conv_ms.train", "k1_roofline", "k2_roofline", "idle_share.gen",
             "idle_share.train")
    for name in names:
        read = bench_run.metric_reader(name)
        assert read(dict(ctx, trace=full)) == read(dict(ctx, trace=plain)), name
    assert bench_run.metric_reader("fir_ms.train")(dict(ctx, trace=full)) == pytest.approx(0.09)
    assert bench_run.metric_reader("k1_roofline")(dict(ctx, trace=full)) == pytest.approx(10.0)
