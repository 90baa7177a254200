"""The port's lres trainer against the benchmark's plain reference
(`h100_bench/reference/gan_lres.py`), on the CPU at `train_lres`'s tiny
preset: the `lres-train` cell's driver runs two cycles of the program
(`train_lres.train_step`, R1 in cycle 0) and of the reference from the same
seeded weights, clips and random draws, in float32, and compares losses,
cycle-0 gradient norms and change norms. A program whose ToRGB weight is 10%
larger than the reference's fails the same tolerances."""

import pytest
import torch

import long_video_gan_tpu_torch.train_lres as train_lres
from h100_bench.drivers.train_lres import Driver
from h100_bench.tests.lres_tiny import tiny_run

TOLERANCES = {
    # The same operations in the same order on the CPU, apart from R1's second
    # derivative (the program's three `ops.conv` kernels, PyTorch's double
    # backward in the reference), which reaches later losses only through
    # cycle 0's D step: the losses agree to float32 rounding.
    "loss_rel": 1e-5,
    "loss0_rel": 1e-5,
    # Cycle 0's gradients: sums in another order at most (read: 1.7e-7).
    "grad_norm_rel": 1e-5,
    "grad_norm_med": 1e-5,
    # Adam divides each leaf's gradient by its running RMS, so a rounding-size
    # gradient gap in a small leaf grows into a larger update gap over two
    # cycles (read: 1.3e-5).
    "change_norm_rel": 1e-3,
}


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _larger_to_rgb(monkeypatch):
    make_gan = train_lres.make_gan

    def make(c, device):
        gan = make_gan(c, device)

        def scale(module, keys):
            with torch.no_grad():
                module.to_rgb.weight.mul_(1.1)

        gan.G.register_load_state_dict_post_hook(scale)
        return gan

    monkeypatch.setattr(train_lres, "make_gan", make)


def _gaps(monkeypatch, perturbed: bool) -> dict:
    if perturbed:
        _larger_to_rgb(monkeypatch)
    driver = Driver(tiny_run(checked_steps=2))
    driver.setup()
    driver.free()
    numbers = driver.check(False)
    assert numbers["compared"] == 5     # G and D in both cycles, R1 in cycle 0
    return {k: v for k, v in numbers.items() if k.split(".")[0] in TOLERANCES}


def _over(gaps: dict) -> list[str]:
    return [k for k, v in gaps.items() if not v <= TOLERANCES[k.split(".")[0]]]


@pytest.mark.parametrize("perturbed", [False, True], ids=["program", "larger_to_rgb"])
def test_program_against_reference(monkeypatch, perturbed):
    gaps = _gaps(monkeypatch, perturbed)
    assert len(gaps) == 15
    if perturbed:
        assert _over(gaps), gaps
    else:
        assert not _over(gaps), gaps
