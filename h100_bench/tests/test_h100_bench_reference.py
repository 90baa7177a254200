"""The reference against the program at the sres trainer's tiny preset on
the CPU: a segment, and three training cycles (losses, G's and D's
gradients and changes)."""

import numpy as np
import pytest
import torch

from h100_bench.common import draw_state
from h100_bench.reference.sres_generator import VideoGenerator as RefGenerator
from h100_bench.reference.sres_generator import segment_window
from h100_bench.tests.helpers import SEED, TINY_SRES_G, run_tiny


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("num_fp16_res, tol", [(0, 2e-5), (2, 2e-2)])
def test_segment_matches_program(num_fp16_res, tol):
    from long_video_gan_tpu_torch.generate import super_resolve
    from long_video_gan_tpu_torch.models.generator_sres import VideoGenerator

    cfg = dict(TINY_SRES_G, num_fp16_res=num_fp16_res)
    ref = RefGenerator(**cfg).eval()
    state = draw_state(ref, SEED, "cpu")
    ref.load_state_dict(state)
    prog = VideoGenerator(**cfg, resample_impl="auto").eval()
    prog.load_state_dict(state)
    g = torch.Generator().manual_seed(3)
    lr = torch.randn((1, 3, 24 + 4, 8, 16), generator=g).clamp(-1, 1)
    z = torch.randn((1, 32), generator=g)
    segments = list(super_resolve(prog, lr, 24, segment_length=8, generator=None, z=z))
    with torch.no_grad():
        for s, got in enumerate(segments):
            want = ref(segment_window(lr, s, 8, 2), z)
            err = (got - want).abs().max() / want.abs().max()
            assert err <= tol, (s, float(err))


def test_training_cycles_match_program_in_float32():
    """With every layer in float32 the reference is the program's plain
    path, so three cycles agree to the last bit on the CPU."""
    result = run_tiny("sres-train", num_fp16_res=0)
    assert result["correct"]
    for name, c in result["checked"].items():
        assert c["value"] == 0.0, (name, c)


def test_sres_training_cycles_close_with_bf16_layers():
    """K1/K2's plain versions (bf16 stage rounding) against the composed
    bf16 reference: inside the cell's limits."""
    result = run_tiny("sres-train", num_fp16_res=2)
    assert result["correct"], result["checked"]
    assert result["checked"]["change_norm_rel.G"]["value"] > 0


def test_weights_are_drawn_from_the_seed():
    ref = RefGenerator(**TINY_SRES_G)
    a, b = draw_state(ref, SEED, "cpu"), draw_state(ref, SEED, "cpu")
    c = draw_state(ref, SEED + 1, "cpu")
    key = next(k for k in a if k.endswith(".weight"))
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    # Constants as built: the affine biases start at 1.
    bias = next(k for k in a if k.endswith("affine.bias"))
    assert np.allclose(a[bias].numpy(), 1.0)
