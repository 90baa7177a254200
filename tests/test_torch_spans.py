"""The port's spans (`utils/profiling.annotate`) on the CPU at tiny sizes.

Three workloads: `super_resolve` of two segments, two sres training cycles
(R1 and ADA in the first) and one lres cycle, each on the `auto` policy, so
that every layer that resamples takes the kernels' plain versions (K1/K2 on
bf16 maps, the f32 kernels on f32 maps) and the 1x1 torgb the composed path.
With no profiler recording, none of them enters a
`torch.profiler.record_function`. Under one, the exported trace holds the
spans a traced window counts: one `lvg.segment` per segment, one
`lvg.layer.*` and one `lvg.filtered_lrelu.*` per layer and G call,
`lvg.update_r1` only in the cycles that call it; backward spans are named
after the forward span that owns them and open inside the autograd engine's
evaluation of their node, on the thread it runs them on (on the CPU, the
caller's). Outputs, gradients and the trained state are bit-equal with the
profiler on and off.
"""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from long_video_gan_tpu_torch.generate import super_resolve
from long_video_gan_tpu_torch.models.common import init_weights_
from long_video_gan_tpu_torch.models.generator_sres import VideoGenerator
from long_video_gan_tpu_torch.train.gan_lres import LowResVideoGAN
from long_video_gan_tpu_torch.train.gan_sres import SuperResVideoGAN

SRES_KW = dict(hr_height=36, hr_width=64, lr_height=9, lr_width=16, temporal_context=2,
               latent_z_dim=32, latent_w_dim=32, margin_size=4, num_fp16_res=2,
               channel_base=1024, channel_max=32, num_layers=6, resample_impl="auto")
SRES_CFG = dict(
    seq_length=2, temporal_context=2, lr_height=9, lr_width=16, hr_height=36, hr_width=64,
    total_batch=4, G_grad_accum=2, D_grad_accum=2,
    G_kwargs={k: v for k, v in SRES_KW.items() if k not in (
        "hr_height", "hr_width", "lr_height", "lr_width", "temporal_context")},
    D_kwargs=dict(channels_base=512, channels_max=32, num_fp16_res=0),
    augment_kwargs=dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
                        brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
)
LRES_CFG = dict(
    seq_length=8, height=18, width=32, total_batch=4, G_grad_accum=2, D_grad_accum=2,
    G_random_temp_translate=True, temp_scale_augment=1.0,
    G_kwargs=dict(temporal_emb_dim=64, latent_w_dim=64, temporal_padding=2, channel_max=32,
                  embedding_kwargs=dict(min_sampling_rate=10, max_sampling_rate=40,
                                        blur_widths=16)),
    D_kwargs=dict(channels_max=32, epilogue_kwargs=dict(channels=64)),
)
SEGMENT = 2
WORKLOADS = ("stream", "sres_cycles", "lres_cycle")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the module runs (the suite runs in several
    worker processes on few cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(seed, *shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).clamp(-1, 1)


def _kernel_layers(net) -> list[str]:
    """The layers `auto` sends to the kernel route: every layer that
    resamples, bf16 (K1/K2) and f32 (the f32 kernels); the 1x1 torgb takes
    the composed path."""
    return [name for name, layer in zip(net.layer_names, net.layers)
            if not (layer.up_factor == layer.down_factor == 1 and layer.up_filter is None)]


def _stream() -> tuple[dict, dict]:
    G = VideoGenerator(**SRES_KW)
    init_weights_(G, torch.Generator().manual_seed(0))
    G.eval().requires_grad_(False)
    lr = _draw(1, 1, 3, 2 * SEGMENT + 2 * SRES_KW["temporal_context"], 9, 16)
    z = _draw(2, 1, SRES_KW["latent_z_dim"])
    segments = list(super_resolve(G, lr, 2 * SEGMENT, segment_length=SEGMENT, generator=None,
                                  z=z))
    net = G.SG3.synthesis
    return ({f"segment{i}": s for i, s in enumerate(segments)},
            dict(segments=2, G=2, layers=net.layer_names, kernel_layers=_kernel_layers(net),
                 phases={}))


def _state(gan) -> dict:
    out = {}
    for name in ("G", "D", "G_ema"):
        out.update({f"{name}.{k}": v.clone() for k, v in getattr(gan, name).state_dict().items()})
    for name in ("opt_G", "opt_D"):
        opt = getattr(gan, name)
        out.update({f"{name}.mu{i}": m.clone() for i, m in enumerate(opt.mu)})
        out.update({f"{name}.nu{i}": n.clone() for i, n in enumerate(opt.nu)})
    return out


def _sres_cycles() -> tuple[dict, dict]:
    gan = SuperResVideoGAN(**SRES_CFG)
    gan.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    lr, hr = _draw(3, 4, 3, 6, 9, 16), _draw(4, 4, 3, 2, 36, 64)
    losses = {}
    for i in range(2):
        losses[f"G{i}"] = gan.update_G(gen, lr)["loss/G_loss"]
        losses[f"D{i}"] = gan.update_D(gen, lr, lr, hr)["loss/D_loss"]
        if i == 0:
            losses["r1"] = gan.update_r1(gen, gan.crop_to_seq_length(lr), hr,
                                         gain=16.0)["loss/r1_loss"]
            gan.update_ada(gain=4.0)
        gan.update_G_ema()
    net = gan.G.SG3.synthesis
    # Each cycle: G on 2 micro-batches in update_G and 2 in update_D.
    return ({**_state(gan), **losses},
            dict(segments=0, G=8, layers=net.layer_names, kernel_layers=_kernel_layers(net),
                 phases={"update_G": 2, "update_D": 2, "update_r1": 1, "update_ada": 1,
                         "update_G_ema": 2, "adam": 5}))


def _lres_cycle() -> tuple[dict, dict]:
    gan = LowResVideoGAN(**LRES_CFG, device="cpu")
    gan.init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    real = _draw(5, 4, 3, 8, 18, 32)
    losses = {"G": gan.update_G(gen)["loss/G_loss"], "D": gan.update_D(gen, real)["loss/D_loss"],
              "r1": gan.update_r1(gen, real, gain=16.0)["loss/r1_loss"]}
    gan.update_G_ema()
    return ({**_state(gan), **losses},
            dict(segments=0, G=4, layers=[], kernel_layers=[],
                 phases={"update_G": 1, "update_D": 1, "update_r1": 1, "update_G_ema": 1,
                         "adam": 3}))


RUN = {"stream": _stream, "sres_cycles": _sres_cycles, "lres_cycle": _lres_cycle}


@pytest.fixture(scope="module")
def unprofiled():
    """Each workload's outputs with no profiler recording, and the number of
    `record_function`s it entered."""
    cache = {}

    def get(name):
        if name not in cache:
            entered = []
            enter = torch.autograd.profiler.record_function.__enter__

            def counting(self):
                entered.append(self.name)
                return enter(self)

            torch.autograd.profiler.record_function.__enter__ = counting
            try:
                out, _ = RUN[name]()
            finally:
                torch.autograd.profiler.record_function.__enter__ = enter
            cache[name] = out, entered
        return cache[name]

    return get


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    """Each workload's outputs, expected counts and chrome-trace events
    under a CPU profiler."""
    cache = {}

    def get(name):
        if name not in cache:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                out, expect = RUN[name]()
            path = tmp_path_factory.mktemp(name) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = [e for e in json.loads(path.read_text())["traceEvents"]
                      if e.get("ph") == "X"]
            cache[name] = out, expect, events
        return cache[name]

    return get


def _spans(events):
    return [e for e in events if e.get("cat") == "user_annotation"
            and e["name"].startswith("lvg.")]


def _inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("name", WORKLOADS)
def test_no_span_without_a_profiler(unprofiled, name):
    _, entered = unprofiled(name)
    assert entered == []


@pytest.mark.parametrize("name", WORKLOADS)
def test_bit_equal_with_the_profiler_on(unprofiled, profiled, name):
    off, _ = unprofiled(name)
    on, _, _ = profiled(name)
    assert off.keys() == on.keys()
    for key in off:
        assert torch.equal(off[key], on[key]), key


@pytest.mark.parametrize("name", WORKLOADS)
def test_forward_span_counts(profiled, name):
    _, expect, events = profiled(name)
    spans = _spans(events)
    count = collections.Counter(s["name"] for s in spans)
    assert count["lvg.segment"] == expect["segments"]
    assert count["lvg.G"] == expect["G"]
    for phase in ("update_G", "update_D", "update_r1", "update_ada", "update_G_ema", "adam"):
        assert count[f"lvg.{phase}"] == expect["phases"].get(phase, 0), phase
    if not expect["layers"]:
        return
    assert count["lvg.prep_cond"] == count["lvg.mapping"] == expect["G"]
    layer_spans = [s for s in spans if s["name"].startswith("lvg.layer.")]
    assert collections.Counter(s["name"] for s in layer_spans) == {
        f"lvg.layer.{layer}": expect["G"] for layer in expect["layers"]}
    forward = [s for s in spans if s["name"].startswith("lvg.filtered_lrelu.")
               and not s["name"].endswith(".bwd")]
    assert len(forward) == len(layer_spans)
    # Each layer's one filtered_lrelu, on the path the policy takes.
    for layer in layer_spans:
        inner = [s["name"] for s in forward if _inside(s, layer)]
        packed = layer["name"][len("lvg.layer."):] in expect["kernel_layers"]
        assert inner == ["lvg.filtered_lrelu.packed" if packed
                         else "lvg.filtered_lrelu.composed"], layer["name"]
    for segment in (s for s in spans if s["name"] == "lvg.segment"):
        assert sum(_inside(s, segment) for s in spans if s["name"] == "lvg.G") == 1


@pytest.mark.parametrize("name", ["sres_cycles", "lres_cycle"])
def test_backward_spans(profiled, name):
    """Each `.bwd` span names a forward span of the trace, opens inside the
    autograd engine's evaluation of a node on that node's thread (an op's
    span closes there too; a module call's, `utils/profiling.layer_span`'s,
    closes inside the evaluation of a later node on that thread), and an
    upfirdn2d's backward inside a composed filtered_lrelu nests in that
    call's `.bwd` span; R1's double backward opens `.bwd.bwd` spans."""
    _, expect, events = profiled(name)
    spans = _spans(events)
    names = {s["name"] for s in spans}
    engine = [e for e in events if e["name"].startswith("autograd::engine::evaluate_function")]
    backward = [s for s in spans if s["name"].endswith(".bwd")]
    assert backward
    for s in backward:
        assert s["name"][:-len(".bwd")] in names, s["name"]
        if s["name"].startswith(("lvg.layer.", "lvg.augment.")):
            end = dict(s, ts=s["ts"] + s["dur"], dur=0)
            assert any(_inside(dict(s, dur=0), e) for e in engine), s["name"]
            assert any(_inside(end, e) for e in engine), s["name"]
        else:
            assert any(_inside(s, e) for e in engine), s["name"]
    composed = [s for s in backward if s["name"] == "lvg.filtered_lrelu.composed.bwd"]
    for s in composed:
        inner = [t["name"] for t in backward if t is not s and _inside(t, s)]
        assert inner == ["lvg.upfirdn2d.conv.bwd"]
    assert "lvg.upfirdn2d.conv.bwd.bwd" in names
    if expect["kernel_layers"]:
        # K2 once per bf16 layer and G micro-batch of update_G.
        count = collections.Counter(s["name"] for s in backward)
        assert count["lvg.filtered_lrelu.packed.bwd"] == (
            expect["phases"]["update_G"] * 2 * len(expect["kernel_layers"]))
        assert composed
