"""The sres stream's synthesis stream (`generator_sres.sample_video_segments`).

CPU part: CPU windows run in turn and count in `segments` alone;
`generate.super_resolve` yields the same bits as the generator called window
by window, whatever the prefetch; `synthesis_stream_share.gen` reads the
counters, and nothing where the program has none.

CUDA part (marker `cuda`, skipped without a card): windows computed on the
synthesis stream are the same bits as the generator called window by window
on the current stream; a consumer's copy of segment k waits for window k
alone, not for the prefetched k+1; a consumer on a stream of its own gets
the same bits; a stream closed early frees its blocks. Runs on the card
without jax installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_segment_stream.py
"""

import pytest
import torch

from h100_bench import run as bench_run
from long_video_gan_tpu_torch import train_sres
from long_video_gan_tpu_torch.generate import super_resolve
from long_video_gan_tpu_torch.models import generator_sres
from long_video_gan_tpu_torch.models.common import init_weights_

SEGMENT = 4
# About 50 ms of device time at the H100's clocks.
SLEEP_CYCLES = 100_000_000


def build_G(preset: str, device) -> generator_sres.VideoGenerator:
    """The sres G of `train_sres`'s `preset`, its weights drawn from seed 0
    on the CPU."""
    kwargs = train_sres.generator_config(train_sres.build_config("", 4, 1, 1.0, preset))
    G = init_weights_(generator_sres.VideoGenerator(**kwargs["kwargs"]),
                      torch.Generator().manual_seed(0))
    return G.eval().requires_grad_(False).to(device)


def inputs(G, segments: int, device, seed: int = 1):
    """An lr video of `segments` windows and its z, drawn on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    frames = segments * SEGMENT + 2 * G.temporal_context
    lr = torch.randn((1, 3, frames, G.lr_height, G.lr_width), generator=gen)
    z = torch.randn((1, G.latent_z_dim), generator=gen)
    return lr.clamp(-1, 1).to(device), z.to(device)


def window_calls(G, lr, z):
    """The generator called on each window in turn, on the current stream."""
    win = SEGMENT + 2 * G.temporal_context
    with torch.no_grad():
        return [G(lr[:, :, s:s + win], z=z)
                for s in range(0, lr.shape[2] - 2 * G.temporal_context, SEGMENT)]


def reset_counters():
    generator_sres.segments = generator_sres.stream_segments = 0


@pytest.fixture(scope="module")
def tiny_G():
    return build_G("tiny", "cpu")


def test_cpu_windows_count_in_segments_alone(tiny_G):
    lr, z = inputs(tiny_G, 3, "cpu")
    reset_counters()
    with torch.no_grad():
        got = list(generator_sres.sample_video_segments(
            tiny_G, lr, segment_length=SEGMENT, temporal_context=tiny_G.temporal_context, z=z))
    assert len(got) == 3
    assert (generator_sres.segments, generator_sres.stream_segments) == (3, 0)


@pytest.mark.parametrize("prefetch", [0, 1, 3])
def test_super_resolve_on_cpu_equals_window_calls(tiny_G, prefetch):
    lr, z = inputs(tiny_G, 3, "cpu")
    want = window_calls(tiny_G, lr, z)
    got = list(super_resolve(tiny_G, lr, 3 * SEGMENT, segment_length=SEGMENT,
                             prefetch=prefetch, generator=None, z=z))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("counters, share", [((4, 4), 100.0), ((4, 2), 50.0), ((0, 0), None)])
def test_share_metric_reads_the_counters(monkeypatch, counters, share):
    monkeypatch.setattr(generator_sres, "segments", counters[0])
    monkeypatch.setattr(generator_sres, "stream_segments", counters[1])
    assert bench_run.metric_reader("synthesis_stream_share.gen")({}) == share


def test_share_metric_is_silent_without_the_counters(monkeypatch):
    monkeypatch.delattr(generator_sres, "segments")
    monkeypatch.delattr(generator_sres, "stream_segments")
    assert bench_run.metric_reader("synthesis_stream_share.gen")({}) is None


# ---------------------------------------------------------------------------
# On the card.


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class SleepyWindows(torch.nn.Module):
    """A stand-in generator: window k >= `sleep_from` first sleeps on the
    device, then writes twice its centre frames plus z's sum into a fresh
    segment; `done[k]` is an event recorded after window k's last launch."""

    latent_z_dim = 4
    temporal_context = 2

    def __init__(self, sleep_from: int):
        super().__init__()
        self.sleep_from = sleep_from
        self.done = []

    def forward(self, window, z, **kwargs):
        out = torch.empty_like(window[:, :, :SEGMENT])
        if len(self.done) >= self.sleep_from:
            torch.cuda._sleep(SLEEP_CYCLES)
        ctx = self.temporal_context
        torch.add(window[:, :, ctx:ctx + SEGMENT] * 2, z.sum(), out=out)
        self.done.append(torch.cuda.current_stream(window.device).record_event())
        return out

    @classmethod
    def want(cls, lr, z):
        ctx = cls.temporal_context
        return [lr[:, :, ctx + s:ctx + s + SEGMENT] * 2 + z.sum()
                for s in range(0, lr.shape[2] - 2 * ctx, SEGMENT)]


def sleepy_inputs(device, segments: int = 3):
    gen = torch.Generator().manual_seed(2)
    lr = torch.randn((1, 3, segments * SEGMENT + 4, 8, 16), generator=gen)
    return lr.to(device), torch.randn((1, 4), generator=gen).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("preset, prefetch", [("tiny", 0), ("tiny", 1), ("tiny", 2),
                                              ("full", 1)])
def test_stream_segments_equal_window_calls(cuda_device, preset, prefetch):
    """The same bits as the generator on the current stream, every window on
    the synthesis stream; "full" is the 144x256 plan (K1 on the bf16
    layers, the f32 kernels on L0-L2)."""
    G = build_G(preset, cuda_device)
    lr, z = inputs(G, 3, cuda_device)
    want = window_calls(G, lr, z)
    reset_counters()
    with torch.no_grad():
        got = [seg.cpu() for seg in generator_sres.sample_video_segments(
            G, lr, segment_length=SEGMENT, temporal_context=G.temporal_context, z=z,
            prefetch=prefetch)]
    assert (generator_sres.segments, generator_sres.stream_segments) == (3, 3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w.cpu())


@pytest.mark.cuda
def test_copy_waits_for_its_own_window_alone(cuda_device):
    """The consumer's `.cpu()` of segment 0 returns while window 1, enqueued
    ahead of it and sleeping ≈ 50 ms on the device, is still running: the
    copy is not queued behind the prefetched window."""
    G = SleepyWindows(sleep_from=1)
    lr, z = sleepy_inputs(cuda_device)
    torch.cuda.synchronize()
    stream = generator_sres.sample_video_segments(
        G, lr, segment_length=SEGMENT, temporal_context=G.temporal_context, z=z, prefetch=1)
    first = next(stream).cpu()
    assert len(G.done) == 2
    assert not G.done[1].query()
    rest = [seg.cpu() for seg in stream]
    for g, w in zip([first, *rest], SleepyWindows.want(lr, z)):
        assert torch.equal(g, w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("module", ["sleepy", "tiny"])
def test_consumer_on_its_own_stream(cuda_device, module):
    """A consumer that works on a stream of its own, reading each segment
    on the device, gets the same bits as the window calls."""
    G = SleepyWindows(sleep_from=0) if module == "sleepy" else build_G("tiny", cuda_device)
    lr, z = sleepy_inputs(cuda_device) if module == "sleepy" else inputs(G, 3, cuda_device)
    want = SleepyWindows.want(lr, z) if module == "sleepy" else window_calls(G, lr, z)
    consumer = torch.cuda.Stream(cuda_device)
    consumer.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.no_grad(), torch.cuda.stream(consumer):
        got = [seg.clone() for seg in generator_sres.sample_video_segments(
            G, lr, segment_length=SEGMENT, temporal_context=G.temporal_context, z=z,
            prefetch=2)]
    torch.cuda.current_stream(cuda_device).wait_stream(consumer)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
def test_closing_early_frees_the_blocks(cuda_device):
    """A consumer that stops after the first segment closes the stream with
    windows still running on the device: nothing raises, and once the
    synthesis stream drains every block it allocated is free again."""
    G = SleepyWindows(sleep_from=1)
    lr, z = sleepy_inputs(cuda_device, segments=4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    stream = generator_sres.sample_video_segments(
        G, lr, segment_length=SEGMENT, temporal_context=G.temporal_context, z=z, prefetch=2)
    first = next(stream)
    stream.close()
    assert not G.done[-1].query()
    del first, stream
    torch.cuda.synchronize()
    torch.empty(1, device=cuda_device)   # an allocation processes the freed blocks' events
    assert torch.cuda.memory_allocated(cuda_device) == base
