"""The port's measurement tools on the CPU: `bench_train`'s cycle against the
JAX script's (phase order, cadence and gains over 17 steps, run through both
with recording trainers), its JSON keys and metric names, one real cycle of
each trainer at the tiny presets, `torch_profile_train`'s cadence weights and
shares, `torch_bench_layers`' per-layer geometry against the JAX
`SynthesisNetwork` at a tiny width, and `torch_bench_prefetch`'s sweep at a
tiny width."""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch import bench_train
from test_torch_generators import SRES_KW
from test_torch_lres_train import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_bench_layers  # noqa: E402
import torch_bench_prefetch  # noqa: E402
import torch_profile_train  # noqa: E402

XLA_KNOBS = {"remat", "block_remat", "accum_unroll"}


def _jax_bench_train():
    spec = importlib.util.spec_from_file_location("jax_bench_train",
                                                  os.path.join(REPO, "bench_train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _RecordingJaxGAN:
    """Stands in for the JAX trainers in `bench_train.py`: records each
    phase call (and its gain) and returns the state unchanged."""
    calls = []

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def init_state(self, key):
        return types.SimpleNamespace(step=np.int32(0))

    def crop_to_seq_length(self, x):
        return x[:, :, 4:-4]

    def update_G(self, state, key, *args):
        self.calls.append(("update_G", None))
        return state, {"loss/G_loss": np.zeros(3, np.float32)}

    def update_D(self, state, key, *args):
        self.calls.append(("update_D", None))
        return state, {}

    def update_r1(self, state, key, *args, gain):
        self.calls.append(("update_r1", gain))
        return state, {}

    def update_ada(self, state, gain):
        self.calls.append(("update_ada", gain))
        return state, {}

    def update_G_ema(self, state):
        self.calls.append(("update_G_ema", None))
        return state


def _recorded_port_bench(kind: str) -> tuple[list, dict]:
    """The port's `measure` over 17 steps of the tiny trainer of `kind`,
    every update method replaced by a recorder: (its calls, its record)."""
    bench = (bench_train.make_lres_bench(2, preset="tiny", device="cpu") if kind == "lres"
             else bench_train.make_sres_bench(2, preset="tiny", device="cpu"))
    calls = []
    for name in ("update_G", "update_D", "update_r1", "update_ada", "update_G_ema"):
        def record(*args, _name=name, gain=None, **kwargs):
            calls.append((_name, gain))
            return {}
        setattr(bench.gan, name, record)
    return calls, bench_train.measure(bench, 17)


@pytest.mark.parametrize("kind", ["lres", "sres"])
def test_cycle_and_json_match_bench_train(kind, monkeypatch):
    """Two warm-up cycles with R1 (sres: and ADA), then R1 at steps 0 and
    16 with gain 16, sres ADA every 4 steps with gain 4, in the JAX order;
    the same JSON keys less the XLA knobs, plus the card."""
    import long_video_gan_tpu.train.gan_lres as jax_gan_lres
    import long_video_gan_tpu.train.gan_sres as jax_gan_sres

    jax_bt = _jax_bench_train()
    _RecordingJaxGAN.calls = []
    if kind == "lres":
        monkeypatch.setattr(jax_gan_lres, "LowResVideoGAN", _RecordingJaxGAN)
        want_record = jax_bt.bench_lres(4, 17)
    else:
        monkeypatch.setattr(jax_gan_sres, "SuperResVideoGAN", _RecordingJaxGAN)
        want_record = jax_bt.bench_sres(4, 17)
    want_calls = list(_RecordingJaxGAN.calls)

    calls, record = _recorded_port_bench(kind)
    assert calls == want_calls
    names = [n for n, _ in calls]
    assert names.count("update_r1") == 2 + 2 and names.count("update_G") == 2 + 17
    assert names.count("update_ada") == (0 if kind == "lres" else 2 + 5)
    assert record["metric"] == want_record["metric"] == (
        bench_train.LRES_METRIC if kind == "lres" else bench_train.SRES_METRIC)
    assert set(record) == (set(want_record) - XLA_KNOBS) | {"device", "power_limit"}
    assert len(record["per_step"]) == 17 and record["unit"] == "sec/step"
    assert record["device"] == "cpu" and record["power_limit"] is None
    assert record["peak_hbm_gb"] is None


@pytest.mark.parametrize("kind, ladders", [("lres", (0, 0)), ("lres", (2, 1)), ("sres", None)])
def test_one_real_cycle_at_the_tiny_presets(kind, ladders, one_torch_thread):  # noqa: F811
    """One step of each trainer's cycle on --device cpu, R1 and ADA
    included (step 0), gives finite losses; the lres one with the G and D
    bf16 ladders too."""
    if kind == "lres":
        bench = bench_train.make_lres_bench(2, *ladders, preset="tiny", device="cpu")
    else:
        bench = bench_train.make_sres_bench(2, preset="tiny", device="cpu")
    stats = bench_train.run_cycle(bench, 0, torch.Generator().manual_seed(0))
    assert list(stats) == [name for name, _, _ in bench.phases]
    bench_train.check_finite(stats)
    losses = [k for s in stats.values() for k in (s or {}) if k.startswith("loss/")]
    assert {"loss/G_loss", "loss/D_loss", "loss/r1_loss"} <= set(losses)
    assert bench.gan.step == 1
    stats["update_G"]["loss/G_loss"] = torch.tensor([1.0, float("nan"), 0.0])
    with pytest.raises(FloatingPointError, match="update_G/loss/G_loss"):
        bench_train.check_finite(stats)


def test_bench_train_cli_on_the_cpu_and_without_a_card(capsys, monkeypatch,
                                                      one_torch_thread):  # noqa: F811
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_train.main(["--config", "sres"])
    # The CLI runs the full presets; here it runs the tiny one.
    full = bench_train.make_sres_bench
    monkeypatch.setattr(bench_train, "make_sres_bench",
                        lambda accum, preset="full", device="cuda": full(accum, "tiny", device))
    out = bench_train.main(["--config", "sres", "--sres-accum", "2", "--steps", "1",
                            "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out[0] and line["grad_accum"] == 2 and np.isfinite(line["value"])


def test_profile_train_weights_and_shares(capsys, tmp_path, one_torch_thread):  # noqa: F811
    rows = [{"phase": "update_G", "sec": 1.0, "weight": 1.0},
            {"phase": "update_D", "sec": 2.0, "weight": 1.0},
            {"phase": "update_r1", "sec": 3.2, "weight": 1 / 16},
            {"phase": "update_ada", "sec": 0.4, "weight": 1 / 4},
            {"phase": "update_G_ema", "sec": 0.1, "weight": 1.0}]
    total = torch_profile_train.step_shares(rows)
    assert total == pytest.approx(1.0 + 2.0 + 0.2 + 0.1 + 0.1)
    assert [r["amortized_sec"] for r in rows] == pytest.approx([1.0, 2.0, 0.2, 0.1, 0.1])
    assert [r["pct_of_step"] for r in rows] == pytest.approx(
        [100 * a / 3.4 for a in (1.0, 2.0, 0.2, 0.1, 0.1)])

    # The JAX script's cadence weights, read off the port's cycle.
    bench = bench_train.make_sres_bench(2, preset="tiny", device="cpu")
    weights = {name: 1 / every for name, _, every in bench.phases}
    assert weights == {"update_G": 1.0, "update_D": 1.0, "update_r1": 1 / 16,
                       "update_ada": 1 / 4, "update_G_ema": 1.0}
    assert torch_profile_train.main(["--config", "lres", "--preset", "tiny", "--steps", "1",
                                     "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    phases, summary = lines[:-1], lines[-1]
    assert [p["phase"] for p in phases] == ["update_G", "update_D", "update_r1", "update_G_ema"]
    assert sum(p["pct_of_step"] for p in phases) == pytest.approx(100)
    assert summary["amortized_sec_per_step"] == pytest.approx(
        sum(p["amortized_sec"] for p in phases))
    # A CPU run's trace holds no kernel: the table is refused, not empty.
    with pytest.raises(RuntimeError, match="no device kernel"):
        torch_profile_train.trace_cycle(bench, str(tmp_path), "update_G_ema")


TINY_NET = dict(w_dim=16, img_width=64, img_height=36, margin_size=4, channel_base=1024,
                channel_max=32, num_layers=6, num_fp16_res=2)


def test_bench_layers_geometry_matches_the_jax_plan():
    net_j = jax_sres.SynthesisNetwork(img_channels=3, cond_channels=27, **TINY_NET)
    plan = net_j.plan()
    conds = [jnp.zeros((1, 27, int(plan["sizes_y"][max(i - 1, 0)]),
                        int(plan["sizes_x"][max(i - 1, 0)]))) for i in range(net_j.num_ws)]
    shapes = jax.eval_shape(lambda: net_j.init(jax.random.key(0),
                                               jnp.zeros((1, net_j.num_ws, 16)), conds))
    variables = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    layers_j = net_j.bind(variables).layers
    rows = torch_bench_layers.layer_rows(torch_bench_layers.plan_network("cpu", **TINY_NET))
    assert len(rows) == len(layers_j) == 7
    dtypes = set()
    for row, lj in zip(rows, layers_j):
        k = lj.kernel
        want = dict(name=lj.name, in_channels=lj.in_channels, out_channels=lj.out_channels,
                    in_hw=(lj.in_size[1], lj.in_size[0]),
                    conv_hw=(lj.in_size[1] + k - 1, lj.in_size[0] + k - 1),
                    out_hw=(lj.out_size[1], lj.out_size[0]), up=lj.up_factor,
                    down=lj.down_factor, kernel=k, padding=tuple(lj.padding),
                    dtype="bfloat16" if lj.use_fp16 else "float32")
        assert row == want
        dtypes.add(row["dtype"])
    assert dtypes == {"float32", "bfloat16"}


def test_bench_layers_runs_every_impl_at_a_tiny_width(capsys, one_torch_thread):  # noqa: F811
    """Every layer and impl timed (host clock on the CPU), K4's refusal
    read as n/a exactly at the top crops py0 <= -up."""
    net = torch_bench_layers.plan_network("cpu", **TINY_NET)
    impls = ("auto", "fused", "conv", "pallas")
    rows = torch_bench_layers.bench_layers(net, 1, impls, 1, torch.Generator().manual_seed(0))
    for row in rows:
        assert row["conv_ms"] > 0
        for impl in impls:
            refused = impl == "pallas" and row["padding"][2] <= -row["up"]
            assert (row["flr_ms"][impl] is None) == refused, (row["name"], impl)
    totals = torch_bench_layers.print_table(rows, impls)
    assert totals["modulated_conv2d"] == pytest.approx(sum(r["conv_ms"] for r in rows))
    assert "filtered_lrelu total [fused]" in capsys.readouterr().out


def test_bench_prefetch_sweep_at_a_tiny_width(one_torch_thread):  # noqa: F811
    G, lr_video, z = torch_bench_prefetch.streaming_inputs(2, 4, "cpu", **SRES_KW)
    assert lr_video.shape == (1, 3, 2 * 4 + 2 * 2, 9, 16)
    records = torch_bench_prefetch.sweep(G, lr_video, z, 4, [0, 1, 2], 1)
    assert [r["prefetch"] for r in records] == [0, 1, 2]
    for r in records:
        assert r["metric"] == "sres_streaming_frames_per_sec_256x144"
        assert r["value"] == pytest.approx(8 / min(r["wall_sec"]))
