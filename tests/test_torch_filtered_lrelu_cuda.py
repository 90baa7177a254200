"""The Hopper filtered_lrelu kernel's wrapper.

CPU part: a CPU tensor never launches the kernel, whatever the impl; the
kernels not ported yet raise; importing the wrapper needs no nvcc.

CUDA part (marker `cuda`, skipped without a card): the kernel against its
plain version at every layer geometry of the 144x256 sres plan that
launches it, through `long_video_gan_tpu_torch.selftest`, the cases and bars
`chip_smoke.py` uses. Runs on the card without jax installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_filtered_lrelu_cuda.py
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from long_video_gan_tpu_torch import selftest
from long_video_gan_tpu_torch.models.generator_sres import SynthesisLayer
from long_video_gan_tpu_torch.ops import filtered_lrelu_cuda
from long_video_gan_tpu_torch.ops.filtered_lrelu import filtered_lrelu, filtered_lrelu_composed
from long_video_gan_tpu_torch.ops.filters import design_kaiser_lowpass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FU = design_kaiser_lowpass(12, 1.0, 2.0, 8.0)


def _inputs(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 12, 16), generator=g).to(dtype)
    b = torch.randn((3,), generator=g).to(dtype)
    return x, b


@pytest.mark.parametrize("impl", ["conv", "matrix", "packed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_never_launches(impl, dtype):
    x, b = _inputs(dtype)
    filtered_lrelu_cuda.launches = 0
    got = filtered_lrelu(x, FU, FU, b, up=2, down=2, padding=(9, 8, 9, 8), clamp=256.0,
                         impl=impl)
    want = filtered_lrelu_composed(x, FU, FU, b, up=2, down=2, padding=(9, 8, 9, 8),
                                   clamp=256.0)
    assert filtered_lrelu_cuda.launches == 0
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


LAYER_KW = dict(w_dim=8, is_torgb=False, is_critically_sampled=False, use_fp16=True,
                in_channels=4, out_channels=4, in_size=(12, 10), out_size=(12, 10),
                in_sampling_rate=16, out_sampling_rate=16, in_cutoff=2.0, out_cutoff=2.0,
                in_half_width=6.0, out_half_width=6.0)


def test_auto_policy_layer_on_cpu_takes_plain():
    """A bf16 SynthesisLayer with resample_impl="auto" selects the kernel
    ("packed"); on a CPU tensor the wrapper computes the plain version."""
    layer = SynthesisLayer(**LAYER_KW, resample_impl="auto")
    plain = SynthesisLayer(**LAYER_KW, resample_impl="conv")
    g = torch.Generator().manual_seed(1)
    for p in layer.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g))
    plain.load_state_dict(layer.state_dict())
    x = torch.randn((2, 4, 10, 12), generator=g)
    w = torch.randn((2, 8), generator=g)
    filtered_lrelu_cuda.launches = 0
    with torch.no_grad():
        got, want = layer(x, w), plain(x, w)
    assert filtered_lrelu_cuda.launches == 0
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("impl,entry", [("fused", "K3"), ("pallas", "K4")])
def test_unported_kernels_raise(impl, entry):
    x, b = _inputs()
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 2, {entry}"):
        filtered_lrelu(x, FU, FU, b, up=2, down=2, padding=9, impl=impl)


def test_kernel_entry_rejects_cpu_tensor():
    x, _ = _inputs()
    with pytest.raises(ValueError, match="CUDA tensor"):
        filtered_lrelu_cuda.filtered_lrelu_fwd_cuda(x, FU, FU, 2, 2, 9, 1.4, 0.2, None)


def test_import_needs_no_nvcc(tmp_path):
    """With no nvcc anywhere, the wrapper imports and serves CPU tensors; only
    a build would need the toolkit."""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"),
               PYTHONPATH=REPO)
    code = (
        "import torch\n"
        "from long_video_gan_tpu_torch.ops import filtered_lrelu_cuda as k\n"
        "from long_video_gan_tpu_torch.utils import nvcc\n"
        "y = k.filtered_lrelu_packed(torch.ones(1, 1, 12, 12), torch.ones(4) / 4,"
        " torch.ones(4) / 4, up=2, down=2, padding=3)\n"
        "assert k.launches == 0 and tuple(y.shape) == (1, 1, 12, 12), y.shape\n"
        "try:\n"
        "    nvcc.find_nvcc()\n"
        "except RuntimeError:\n"
        "    print('no nvcc')\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no nvcc" in out.stdout


# ---------------------------------------------------------------------------
# On the card.


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    filtered_lrelu_cuda.library()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def plan_layers():
    return selftest.plan_layers()


@pytest.mark.cuda
@pytest.mark.parametrize("idx", selftest.KERNEL_LAYERS)
def test_kernel_matches_plain_bf16(idx, cuda_device, plan_layers):
    name, layer = plan_layers[idx]
    gen = torch.Generator().manual_seed(idx)
    check = selftest.check_layer(layer, name, 16, torch.bfloat16, cuda_device, gen)
    assert check.ok, check


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [0, 3])
def test_kernel_matches_plain_f32(idx, cuda_device, plan_layers):
    name, layer = plan_layers[idx]
    gen = torch.Generator().manual_seed(100 + idx)
    check = selftest.check_layer(layer, name, 16, torch.float32, cuda_device, gen)
    assert check.ok, check


@pytest.mark.cuda
def test_kernel_counts_launches_and_skips_trivial(cuda_device):
    x = torch.randn((2, 3, 12, 16), device=cuda_device)
    filtered_lrelu_cuda.launches = 0
    filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="packed")
    assert filtered_lrelu_cuda.launches == 1
    filtered_lrelu(x, None, None, None, up=1, down=1, impl="packed")    # identity resample
    filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="conv")
    assert filtered_lrelu_cuda.launches == 1


@pytest.mark.cuda
def test_kernel_refuses_gradient(cuda_device):
    x = torch.randn((1, 2, 12, 16), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="packed")
    with torch.no_grad():
        y = filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="packed")
    assert not y.requires_grad


@pytest.mark.cuda
def test_kernel_rejects_bad_input(cuda_device):
    x = torch.randn((1, 2, 12, 16), device=cuda_device)
    with pytest.raises(TypeError):
        filtered_lrelu_cuda.filtered_lrelu_fwd_cuda(x.half(), FU, FU, 2, 2, 9, 1.4, 0.2, None)
    with pytest.raises(ValueError, match="contiguous"):
        filtered_lrelu_cuda.filtered_lrelu_fwd_cuda(x.transpose(2, 3), FU, FU, 2, 2, 9,
                                                    1.4, 0.2, None)
    with pytest.raises(ValueError, match="separable"):
        filtered_lrelu_cuda.filtered_lrelu_fwd_cuda(x, np.outer(FU, FU), FU, 2, 2, 9,
                                                    1.4, 0.2, None)
