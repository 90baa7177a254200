"""`metrics/synthesis_stream_share.gen.py`: the share of the sres windows
the program enqueued on its synthesis stream, read from its counters;
nothing from a program whose `generator_sres` has no such counters, as
before they were added, or that enqueued no window."""

import sys
import types

import pytest

import long_video_gan_tpu_torch.models as models
from h100_bench import run as bench_run
from long_video_gan_tpu_torch.models import generator_sres

NAME = "synthesis_stream_share.gen"


def test_nothing_from_a_program_without_the_counters(monkeypatch):
    parent = types.ModuleType(generator_sres.__name__)
    parent.VideoGenerator = generator_sres.VideoGenerator
    monkeypatch.setitem(sys.modules, generator_sres.__name__, parent)
    monkeypatch.setattr(models, "generator_sres", parent)
    assert bench_run.metric_reader(NAME)({}) is None


@pytest.mark.parametrize("segments, stream_segments, share",
                         [(64, 64, 100.0), (68, 64, 100.0 * 64 / 68), (8, 0, 0.0), (0, 0, None)])
def test_share_of_the_counters(monkeypatch, segments, stream_segments, share):
    monkeypatch.setattr(generator_sres, "segments", segments)
    monkeypatch.setattr(generator_sres, "stream_segments", stream_segments)
    got = bench_run.metric_reader(NAME)({})
    assert got == (None if share is None else pytest.approx(share))
