"""The lres trainer's spans and `ops.conv`'s call counters on the CPU at
`train_lres`'s tiny preset (batch 4 in two micro-batches, R1 every 2 steps).

Under `torch.profiler`, one cycle at step 0 (G, D, R1, G_ema) opens
`lvg.temporal_emb` and each G block's span once per G call (two in update_G,
two in update_D) and each block's `.bwd` once per micro-batch of update_G;
each D block and the epilogue once per D call, with a `.bwd` for every
backward pass that runs through them from an input that requires a
gradient; `lvg.augment` once per D call; `lvg.conv.*` once per `ops.conv`
call. Every `.bwd` span that opens closes. The counters move wherever G or D
convolves, since both convolve through `ops.conv`; R1 runs no convolution
whose result nothing reads. With no profiler recording, a cycle enters no
`record_function`."""

import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from long_video_gan_tpu_torch.ops import conv
from long_video_gan_tpu_torch.train_lres import build_config, make_gan, train_step
from long_video_gan_tpu_torch.utils import profiling

G_BLOCKS = [f"temporal{i}" for i in range(6)] + [f"spatial{i}" for i in range(4)] + ["to_rgb"]
D_BLOCKS = [f"block{i}" for i in range(4)] + ["epilogue"]
COUNTERS = ("fwd_calls", "input_grad_calls", "weight_grad_calls", "skipped_calls")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer():
    c = build_config("", 4, 2, 1.0, "tiny")
    gan = make_gan(c, torch.device("cpu"))
    gan.init_state(torch.Generator().manual_seed(0))
    real = torch.randn((4, 3, c["seq_length"], c["height"], c["width"]),
                       generator=torch.Generator().manual_seed(1)).clamp(-1, 1)
    return c, gan, real


def _counters() -> dict:
    return {name: getattr(conv, name) for name in COUNTERS}


def _moved(before: dict) -> dict:
    return {name: getattr(conv, name) - before[name] for name in COUNTERS}


@pytest.fixture(scope="module")
def cycle(tmp_path_factory):
    """Span counts of one profiled cycle at step 0, and the counters' moves
    in each of its phases."""
    c, gan, real = _trainer()
    moves = {}
    for name in ("update_G", "update_D", "update_r1"):
        def counted(*args, name=name, method=getattr(gan, name), **kwargs):
            before = _counters()
            out = method(*args, **kwargs)
            moves[name] = _moved(before)
            return out
        setattr(gan, name, counted)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(gan, torch.Generator().manual_seed(2), c, 0, iter([real, real]))
    path = tmp_path_factory.mktemp("lres_spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = collections.Counter(
        e["name"] for e in json.loads(path.read_text())["traceEvents"]
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"
        and e["name"].startswith("lvg."))
    return spans, moves


def test_generator_spans(cycle):
    spans, _ = cycle
    assert spans["lvg.G"] == spans["lvg.temporal_emb"] == 4
    for block in G_BLOCKS:
        assert spans[f"lvg.layer.{block}"] == 4, block
        assert spans[f"lvg.layer.{block}.bwd"] == 2, block


def test_discriminator_and_augment_spans(cycle):
    """D runs 8 times: 2 in update_G, 2 x 2 in update_D, 2 in update_R1.
    A first-order backward runs through a block from its input wherever that
    requires a gradient: every D call of update_G and R1, and in update_D all
    but block 0 (the clips require none). R1's second derivative runs
    through the gradient's graph alone: no gradient of zeros goes back
    through the blocks' or the augmentations' forward."""
    spans, _ = cycle
    assert spans["lvg.D"] == spans["lvg.augment"] == 8
    assert spans["lvg.augment.bwd"] == 2 + 2
    for block in D_BLOCKS:
        first = 2 + 2 if block == "block0" else 2 + 4 + 2
        assert spans[f"lvg.layer.D.{block}"] == 8, block
        assert spans[f"lvg.layer.D.{block}.bwd"] == first, block


def test_every_backward_span_closes(cycle):
    assert not any(getattr(profiling._open, "marked", {}).values())
    assert not getattr(profiling._open, "names", [])


def test_conv_spans_and_counters(cycle):
    """Per R1 phase, with k = D's `ops.conv` calls per forward times the
    micro-batches: k forwards and k input gradients (D and its gradient),
    then k forwards and k weight gradients (the gradient's derivative); the
    first backward's k weight gradients, which nothing reads, are skipped.

    G convolves through `ops.conv` too: 31 calls a forward (ten blocks of two
    modulated convolutions and a 1x1x1 skip, and ToRGB), D 17 (four blocks of
    three, from-RGB in block 0, four conv1d). Per micro-batch, update_G runs
    G and D forward (31 + 17), every input gradient (31 + 17: G's first input
    depends on its learned constant) and G's 31 weight gradients (D's weights
    are frozen); update_D runs G forward without a gradient (31) and D on the
    fakes and the reals (2 x 17), D's 2 x 17 weight gradients and 2 x 16
    input gradients (all but from-RGB's, whose input is the clips)."""
    spans, moves = cycle
    for kind, counter in (("fwd", "fwd_calls"), ("input_grad", "input_grad_calls"),
                          ("weight_grad", "weight_grad_calls")):
        assert spans[f"lvg.conv.{kind}"] == sum(m[counter] for m in moves.values()), kind
    _, gan, real = _trainer()
    before = _counters()
    with torch.no_grad():
        gan.D(real[:1])
    per_forward = _moved(before)["fwd_calls"]
    k = per_forward * gan.D_grad_accum
    assert per_forward == 17 and k == 34
    assert moves["update_r1"] == dict(fwd_calls=2 * k, input_grad_calls=k,
                                      weight_grad_calls=k, skipped_calls=k)
    micro = gan.G_grad_accum
    assert moves["update_G"] == dict(fwd_calls=micro * (31 + 17),
                                     input_grad_calls=micro * (31 + 17),
                                     weight_grad_calls=micro * 31, skipped_calls=0)
    assert moves["update_D"] == dict(fwd_calls=micro * (31 + 2 * 17),
                                     input_grad_calls=micro * 2 * 16,
                                     weight_grad_calls=micro * 2 * 17, skipped_calls=0)


def test_counters_still_without_r1_or_d():
    """Without R1 or D the counters move by G's forwards alone: 31
    convolutions a G call without a gradient, none in the G_ema update."""
    c, gan, real = _trainer()
    before = _counters()
    with torch.no_grad():
        gan.generate(torch.Generator().manual_seed(3), 2)
    gan.update_G_ema()
    assert _moved(before) == dict(dict.fromkeys(COUNTERS, 0), fwd_calls=31)
    calls = []
    update_r1 = gan.update_r1
    gan.update_r1 = lambda *a, **k: calls.append(1) or update_r1(*a, **k)
    train_step(gan, torch.Generator().manual_seed(4), c, 1, iter([real]))
    assert calls == []


def test_no_span_without_a_profiler():
    c, gan, real = _trainer()
    entered = []
    enter = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return enter(self)

    torch.autograd.profiler.record_function.__enter__ = counting
    try:
        train_step(gan, torch.Generator().manual_seed(2), c, 0, iter([real, real]))
    finally:
        torch.autograd.profiler.record_function.__enter__ = enter
    assert entered == []
