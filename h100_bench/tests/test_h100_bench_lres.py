"""The `lres-train` cell on the CPU at the lres trainer's tiny preset: its
check reads `correct` with the cell's own limits, its control compares, its
traced run finds every span its readers count, its reference imports
nothing of the program, and its operation count is the model's work."""

import json

import pytest
import torch
import torch.nn.functional as F

from h100_bench import flops
from h100_bench import run as bench_run
from h100_bench.drivers import train_lres
from h100_bench.tests.lres_tiny import tiny_run
from h100_bench.tests.test_h100_bench_layout import FORBIDDEN, ROOT, loaded_modules, top_level


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def run_cell() -> dict:
    run = tiny_run()
    e2e, per_layer = bench_run.benchmark_entries("lres-train")
    return bench_run.run_cell(run, e2e, per_layer, 0.0)


def test_sound_run_is_correct():
    result = run_cell()
    assert result["correct"], result["checked"]
    assert set(result["metrics"]) == {"train_s_per_step", "peak_mem_gib", "setup_s"}
    json.dumps(result)


def test_control_compares():
    """On the CPU TF32 changes nothing, so the control reads as the sound
    run does; it has to compare all the same."""
    driver = train_lres.Driver(tiny_run(control=True))
    driver.setup()
    driver.free()
    assert driver.check(True)["compared"] > 0


def test_traced_run_finds_what_its_readers_count():
    """Every G block span once per G call and its `.bwd` once per G
    micro-batch of update_G, R1's double backward through `ops.conv`, and a
    positive operation count; the readers of device time read nothing on
    the CPU, whose trace holds no device event."""
    driver = train_lres.Driver(tiny_run())
    driver.setup()
    ctx = driver.traced()
    st = ctx["spans"]
    names = [f"lvg.layer.temporal{i}" for i in range(6)] + [
        f"lvg.layer.spatial{i}" for i in range(4)] + ["lvg.layer.to_rgb"]
    for name in names:
        assert st.count(name) == ctx["G_forwards"] + ctx["G_backwards"], name
        assert st.count(f"{name}.bwd") == ctx["G_backwards"], name
    assert ctx["r1_conv_calls"]["input_grad_calls"] > 0
    assert ctx["r1_conv_calls"]["weight_grad_calls"] > 0
    assert ctx["flops"] > 0 and ctx["host_s"] > 0
    assert set(ctx["phase_ms"]) == set(train_lres.PHASE_NAMES)
    _, per_layer = bench_run.benchmark_entries("lres-train")
    for m in per_layer:
        value = bench_run.metric_reader(m["name"])(ctx)
        if m["source"] == "device_trace":
            assert value is None, m["name"]
        else:
            assert value is not None and value > 0, m["name"]
    driver.free()


def test_lres_reference_imports_no_program():
    code = "\n".join(f"import h100_bench.reference.{name}" for name in (
        "lres_generator", "lres_discriminator", "diff_augment", "gan_lres"))
    names = top_level(loaded_modules(code))
    assert not names & {*FORBIDDEN, "long_video_gan_tpu_torch"}, sorted(names)
    assert (ROOT / "h100_bench" / "reference" / "gan_lres.py").is_file()


def test_operation_count_is_stable():
    driver = train_lres.Driver(tiny_run())
    driver.c = train_lres.cli_config(driver.config)
    driver.pool = driver._pool()
    r1, plain = driver._step_flops(0), driver._step_flops(1)
    assert r1 == driver._step_flops(0) and plain == driver._step_flops(1)
    assert r1 > plain > 0


class _Capture(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket == torch.ops.aten.convolution:
            self.calls.append((args, out))
        return out


def test_whole_output_filter_term_counts_as_the_weight_gradient():
    """PyTorch's double backward of a convolution (R1's second derivative
    in the reference) computes the weight term as a convolution of the
    transposed input with the transposed output gradient as its filter.
    The count gives it what the weight gradient of the layer costs, so the
    operation count does not depend on which of the two routes runs."""
    x = torch.empty(2, 4, 6, 8, 8, device="meta", requires_grad=True)
    w = torch.empty(5, 4, 3, 3, 3, device="meta", requires_grad=True)
    with _Capture() as capture:
        y = F.conv3d(x, w, padding=1)
        (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        g.square().sum().backward()
    whole = [(a, out) for a, out in capture.calls if a[1].shape[2:] == y.shape[2:]]
    assert len(whole) == 1
    args, out = whole[0]
    term = flops.count_flops(lambda: torch.ops.aten.convolution(*args))
    weight_grad = flops.count_flops(lambda: torch.ops.aten.convolution_backward(
        torch.empty_like(y), x.detach(), w.detach(), None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
        False, [0, 0, 0], 1, [False, True, False]))
    assert term == weight_grad == 2 * y.numel() * 4 * 27


def test_harness_imports_no_jax():
    """`h100_bench.run` with the cell's driver, the program modules it drives
    and its metric readers."""
    code = (
        "from h100_bench import run\n"
        "cell, config, traffic = run.load_cell('lres-train')\n"
        "run.driver_for(traffic)\n"
        "for m in run.benchmark_entries('lres-train')[1]: run.metric_reader(m['name'])\n"
        "import h100_bench.drivers.train_lres, h100_bench.spans\n"
        "import long_video_gan_tpu_torch.train_lres\n")
    names = top_level(loaded_modules(code))
    assert not names & set(FORBIDDEN), sorted(names & set(FORBIDDEN))
    assert "long_video_gan_tpu_torch" in names
