"""`correct` has to come out false for the control and for each fault a
cell can have, with the cells' own limits.

On the CPU, at the tiny sizes of `helpers.tiny_cell`: the control (the
reference one precision lower in the program's place), an answer altered
where it is produced (stream), a step that leaves the state unchanged, half
of each micro-batch left out with the mean over the rest, and K2's input
gradient scaled by 1.1 (training). The training cells' limits sit between
readings taken at full size, so at the tiny size their control is held to
separate from the sound run instead. The `cuda` tests run the harness on
the card at the cells' own sizes, three seeds each, and see the control,
the half batch and the scaled K2 come out not correct there; each prints
every number its check read."""

import json
import math

import pytest
import torch

from h100_bench.tests.helpers import run_full, run_tiny

CARD_SEEDS = (2 ** 33 + 11, 2 ** 33 + 12, 2 ** 33 + 13)
K2_SCALE = 1.1


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def half_batch(monkeypatch):
    """Each micro-batch's second half left out, the mean over the rest."""
    from long_video_gan_tpu_torch.train.gan_sres import SuperResVideoGAN

    chunks = SuperResVideoGAN._chunks
    monkeypatch.setattr(SuperResVideoGAN, "_chunks", lambda self, x, accum: tuple(
        c[:max(1, c.shape[0] // 2)] for c in chunks(self, x, accum)))


def scaled_k2(monkeypatch):
    """K2's input gradient (its plain version on the CPU) times K2_SCALE at
    every launch: an error that keeps every sign."""
    from long_video_gan_tpu_torch.ops import filtered_lrelu_bands, filtered_lrelu_cuda

    for module, name in ((filtered_lrelu_cuda, "filtered_lrelu_bwd_cuda"),
                         (filtered_lrelu_bands, "banded_bwd_plain")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, fn=fn, **k: fn(*a, **k) * K2_SCALE)


FAULTS = {"half_batch": half_batch, "scaled_k2": scaled_k2}


@pytest.mark.parametrize("cell", ["sres-stream", "sres-train"])
def test_sound_run_is_correct(cell):
    assert run_tiny(cell)["correct"]


def test_stream_control_is_not_correct():
    result = run_tiny("sres-stream", control=True)
    assert not result["correct"], result["checked"]


def test_training_control_separates():
    """The cell's limits were set at full size, where the program's own
    readings are larger; at the tiny size a compared number of the control
    reads three times the sound run's or more (the float32 sound run reads
    0: the reference is the program's plain path there)."""
    sound = run_tiny("sres-train", num_fp16_res=0)["checked"]
    control = run_tiny("sres-train", control=True, num_fp16_res=0)["checked"]
    assert any(control[k]["value"] > 0 and control[k]["value"] >= 3 * sound[k]["value"]
               for k in sound), (sound, control)


def test_altered_answer_is_not_correct():
    def alter(segment):
        segment = segment.clone()
        segment[:, :, -1] += 0.1 * segment.abs().max()
        return segment

    result = run_tiny("sres-stream", alter=alter)
    assert not result["correct"], result["checked"]


def test_unchanged_state_is_not_correct(monkeypatch):
    from long_video_gan_tpu_torch.train import common

    monkeypatch.setattr(common.Adam, "step", lambda self, grads, lrate: None)
    result = run_tiny("sres-train")
    assert not result["correct"], result["checked"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_training_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_tiny("sres-train")
    assert not result["correct"], result["checked"]


def card_readings(cell: str, what: str, seed: int, **kwargs) -> dict:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell at its own size")
    result = run_full(cell, seed, **kwargs)
    numbers = {k: c["value"] for k, c in result["checked"].items()}
    print(json.dumps({"cell": cell, "what": what, "seed": seed, "correct": result["correct"],
                      "numbers": {k: v for k, v in numbers.items() if math.isfinite(v)}}),
          flush=True)
    return result


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
@pytest.mark.parametrize("cell", ["sres-stream", "sres-train"])
def test_control_on_the_card(cell, seed):
    assert not card_readings(cell, "control", seed, control=True)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_training_fault_on_the_card(fault, seed, monkeypatch):
    if torch.cuda.is_available():
        FAULTS[fault](monkeypatch)
    assert not card_readings("sres-train", fault, seed)["correct"]
