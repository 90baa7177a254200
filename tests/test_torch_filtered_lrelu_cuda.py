"""The Hopper filtered_lrelu kernels' wrappers: K1 forward and K2 backward
("packed"), K3a forward and K3b backward ("fused"), K4 ("pallas") and K5
(`filtered_lrelu_pallas_v2`).

CPU part: a CPU tensor never launches a kernel, whatever the impl or entry
point, and "packed" computes its plain version, the stage-rounded banded
products (`filtered_lrelu_bands.py`); the selftest's checks run plain against
plain there; importing the wrappers needs no nvcc.

CUDA part (marker `cuda`, skipped without a card): each kernel against its
plain version at the layer geometries of the 144x256 sres plan that launch
it, through `long_video_gan_tpu_torch.selftest`, the cases and bars
`chip_smoke.py` uses, and each entry point's launch counts. Runs on the card
without jax installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_filtered_lrelu_cuda.py
"""

import copy
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from long_video_gan_tpu_torch import selftest
from long_video_gan_tpu_torch.models.generator_sres import SynthesisLayer
from long_video_gan_tpu_torch.ops import (filtered_lrelu_bands, filtered_lrelu_cuda,
                                          filtered_lrelu_exact, filtered_lrelu_fused,
                                          filtered_lrelu_polyphase)
from long_video_gan_tpu_torch.ops.filtered_lrelu import (filtered_lrelu, filtered_lrelu_composed,
                                                        output_size)
from long_video_gan_tpu_torch.ops.filters import design_kaiser_lowpass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FU = design_kaiser_lowpass(12, 1.0, 2.0, 8.0)
# Frames of a training micro-batch at the full preset, grad-accum 2: 16 clips x 4.
TRAIN_FRAMES = 16 * 4


def _inputs(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 12, 16), generator=g).to(dtype)
    b = torch.randn((3,), generator=g).to(dtype)
    return x, b


@pytest.mark.parametrize("impl", ["conv", "matrix", "packed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensor_never_launches(impl, dtype):
    x, b = _inputs(dtype)
    filtered_lrelu_cuda.launches = filtered_lrelu_cuda.f32_launches = 0
    got = filtered_lrelu(x, FU, FU, b, up=2, down=2, padding=(9, 8, 9, 8), clamp=256.0,
                         impl=impl)
    kw = dict(up=2, down=2, padding=(9, 8, 9, 8), gain=2 ** 0.5, slope=0.2, clamp=256.0)
    if impl == "packed":
        want = filtered_lrelu_bands.banded_fwd_plain(x + b.reshape(1, -1, 1, 1), FU, FU, **kw)
    else:
        want = filtered_lrelu_composed(x, FU, FU, b, **kw)
    assert filtered_lrelu_cuda.launches == filtered_lrelu_cuda.f32_launches == 0
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


LAYER_KW = dict(w_dim=8, is_torgb=False, is_critically_sampled=False, use_fp16=True,
                in_channels=4, out_channels=4, in_size=(12, 10), out_size=(12, 10),
                in_sampling_rate=16, out_sampling_rate=16, in_cutoff=2.0, out_cutoff=2.0,
                in_half_width=6.0, out_half_width=6.0)


def test_auto_policy_layer_on_cpu_takes_plain():
    """A bf16 SynthesisLayer with resample_impl="auto" selects the kernel
    ("packed"); on a CPU tensor the wrapper computes the plain version, the
    stage-rounded products that "fused" computes there too."""
    layer = SynthesisLayer(**LAYER_KW, resample_impl="auto")
    plain = SynthesisLayer(**LAYER_KW, resample_impl="fused")
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


def test_auto_policy_sends_f32_layers_to_the_kernel_route():
    """`auto` takes the kernel route on f32 layers too (the f32 kernels on
    the card): an f32 SynthesisLayer on a CPU tensor computes the banded
    plain version exactly, within f32 rounding of the composed path, and
    launches nothing."""
    kw = dict(LAYER_KW, use_fp16=False)
    layer = SynthesisLayer(**kw, resample_impl="auto")
    composed = SynthesisLayer(**kw, resample_impl="conv")
    g = torch.Generator().manual_seed(4)
    for p in layer.parameters():
        p.data.copy_(torch.randn(p.shape, generator=g))
    composed.load_state_dict(layer.state_dict())
    x = torch.randn((2, 4, 10, 12), generator=g)
    w = torch.randn((2, 8), generator=g)
    seen = []
    plain = filtered_lrelu_bands.banded_fwd_plain

    def recording(xb, *args, **kwargs):
        out = plain(xb, *args, **kwargs)
        seen.append((xb, args, kwargs, out))
        return out

    _reset_counts()
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(filtered_lrelu_bands, "banded_fwd_plain", recording)
        got = layer(x, w)
    want = composed(x, w)
    assert _counts() == (0,) * 6 and _f32_counts() == (0, 0)
    assert got.dtype == torch.float32 and len(seen) == 1
    xb, args, kwargs, out = seen[0]
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    torch.testing.assert_close(plain(xb, *args, **kwargs), out, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


def test_selftest_compares_in_reference_slices():
    """The on-card check computes its f32 reference REF_FRAMES frames at a
    time; on a CPU tensor (plain against plain) every slice, the last partial
    one included, agrees exactly, and the shape check sees all frames."""
    layer = SynthesisLayer(**LAYER_KW, resample_impl="auto")
    frames = 2 * selftest.REF_FRAMES + 3
    check = selftest.check_layer(layer, "small", frames, torch.float32, torch.device("cpu"),
                                 torch.Generator().manual_seed(3))
    assert check.ok and check.max_abs_err == 0.0, check
    assert check.shape[0] == frames


def _reset_counts():
    filtered_lrelu_cuda.launches = filtered_lrelu_cuda.bwd_launches = 0
    filtered_lrelu_cuda.f32_launches = filtered_lrelu_cuda.f32_bwd_launches = 0
    filtered_lrelu_fused.fwd_launches = filtered_lrelu_fused.bwd_launches = 0
    filtered_lrelu_exact.launches = filtered_lrelu_polyphase.launches = 0


def _counts():
    return (filtered_lrelu_cuda.launches, filtered_lrelu_cuda.bwd_launches,
            filtered_lrelu_fused.fwd_launches, filtered_lrelu_fused.bwd_launches,
            filtered_lrelu_exact.launches, filtered_lrelu_polyphase.launches)


def _f32_counts():
    return filtered_lrelu_cuda.f32_launches, filtered_lrelu_cuda.f32_bwd_launches


ENTRIES = {
    "fused": lambda *a, **k: filtered_lrelu(*a, impl="fused", **k),
    "pallas": lambda *a, **k: filtered_lrelu(*a, impl="pallas", **k),
    "pallas_v2": filtered_lrelu_polyphase.filtered_lrelu_pallas_v2,
}


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_new_entries_on_cpu_take_plain(entry, dtype):
    """The K3-K5 entry points on a CPU tensor compute their plain versions
    (for bf16 within selftest's bar of the f32 composed op: K3 rounds four
    stages to bf16) and launch nothing."""
    x, b = _inputs(dtype)
    _reset_counts()
    got = ENTRIES[entry](x, FU, FU, b, up=2, down=2, padding=(9, 8, 9, 8), clamp=256.0)
    want = filtered_lrelu_composed(x.float(), FU, FU, b.float(), up=2, down=2,
                                   padding=(9, 8, 9, 8), clamp=256.0)
    assert _counts() == (0,) * 6
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else selftest.TOLS[dtype] * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("kernel", list(selftest.KERNELS))
def test_selftest_checks_every_kernel_on_cpu(kernel):
    """selftest's check of each kernel runs its plain version against itself
    on a CPU tensor: an exact agreement, at the kernel's own bar (K3b in f32
    at its own act' decisions, where the tile contraction stands in for its
    check-only launch: every U within reach, dX within TOLS[f32])."""
    layer = SynthesisLayer(**LAYER_KW, resample_impl="auto")
    check = selftest.check_layer(layer, "small", 3, torch.float32, torch.device("cpu"),
                                 torch.Generator().manual_seed(4), kernel=kernel)
    assert check.ok and check.max_abs_err == 0.0, check
    assert check.tol == {"K3a": 1e-6, "K4": 1e-6, "K5": 1e-6}.get(kernel, 1e-4)
    if kernel == "K3b":
        assert check.u_reach_share == 0.0 and check.u_signs == 0, check
        assert check.tiles_rel_err <= 1e-5 and check.dump_equal is None, check
    else:
        assert check.u_reach_share is None, check
    # K4 and K5 in bf16: 1e-6 of the scale beyond half an ulp of each element.
    bf16_tol = {"K1": 2 ** -7, "K3a": 2 ** -7, "K4": 1e-6, "K5": 1e-6}.get(kernel, 0.03)
    assert selftest.KERNELS[kernel].tol(torch.bfloat16) == bf16_tol
    assert selftest.KERNELS[kernel].bf16_half_ulp == (kernel in ("K4", "K5"))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3a", "K3b"])
def test_selftest_bf16_bars_on_cpu(kernel):
    """In bf16 the selftest holds K1 and K3a to the share of elements off by
    more than one ulp, K2 and K3b to K2's bars beyond act' flips; plain
    against plain on a CPU tensor reads zero on each and reports the share a
    flip can reach."""
    layer = SynthesisLayer(**LAYER_KW, resample_impl="auto")
    check = selftest.check_layer(layer, "small", 3, torch.bfloat16, torch.device("cpu"),
                                 torch.Generator().manual_seed(5), kernel=kernel)
    assert check.ok and check.max_abs_err == 0.0, check
    if not selftest.KERNELS[kernel].backward:
        assert check.ulp_share == 0.0 and check.over is None, check
    else:
        assert check.ulp_share is None and check.over == check.beyond_flips_rel_err == 0, check
        assert check.elements == math.prod(check.shape) and 0.0 < check.reach_share <= 1.0, check


def test_served_layers_of_the_plan(plan_layers):
    served = {k: selftest.served_layers(k, plan_layers) for k in selftest.KERNELS}
    assert served["K1"] == served["K2"] == list(selftest.KERNEL_LAYERS)
    assert {k: selftest.served_layers(k, plan_layers) for k in selftest.F32_KERNELS} == {
        "K1f32": [0, 1, 2], "K2f32": [0, 1, 2]}
    assert served["K3a"] == served["K3b"] == list(range(14))
    assert served["K4"] == served["K5"] == [0, 1, 2, 4, 6, 8, 9, 11, 12, 14]
    # L10 at 16 frames: ~25 GFLOP, ~0.49 GB of bf16 maps. bf16 products at
    # 989 TFLOP/s take ~0.026 ms, so the bytes at 3.35 TB/s bound it (~0.145
    # ms); the same operations in f32 as K4 and K5 take them, six bf16 passes
    # on the tensor cores (989/6 TFLOP/s), take ~0.154 ms and bound it (at the
    # f32 CUDA-core peak of 67 TFLOP/s they would take ~0.38 ms).
    layer = plan_layers[10][1]
    ms, by = selftest.bound(layer, 16, torch.bfloat16, backward=False)
    assert by == "bytes" and 0.13 < ms < 0.16
    for dtype in (torch.bfloat16, torch.float32):
        for kernel in ("K4", "K5"):
            assert selftest.KERNELS[kernel].peak_flops(dtype) == selftest.SPLIT_F32_FLOPS
    ms, by = selftest.bound(layer, 16, torch.bfloat16, backward=False,
                            peak_flops=selftest.KERNELS["K4"].peak_flops(torch.bfloat16))
    assert by == "operations" and 0.15 < ms < 0.16


def _plan_case(layer, idx, planes=8):
    """A plan layer's seeded bf16 input on `planes` planes, its output
    gradient, filters and keyword arguments."""
    g = torch.Generator().manual_seed(idx)
    x, fu, fd, kw = selftest._layer_inputs(layer, 1, torch.bfloat16, torch.device("cpu"), g)
    x = x[:, :planes].contiguous()
    out_hw = output_size(x.shape[2], x.shape[3], fu, fd, kw["up"], kw["down"], kw["padding"])
    dy = torch.randn((1, planes) + out_hw, generator=g).bfloat16()
    return x, dy, fu, fd, kw


def _ulp_bars_refuse_unrounded_stages(kernel, idx, variant, plan_layers):
    """`kernel`'s bf16 bars (K1's pair: max-abs K1_TOL and K1_ULP_SHARE) fail
    the same products with f32 stages, or the composed op in f32 (W pass
    first, the order of the f32 kernel), at plan layer `idx` on 8 planes,
    through the share of elements more than one bf16 ulp of their own off
    (the max-abs bar alone passes some); the plain version passes them."""
    name, layer = plan_layers[idx]
    x, _, fu, fd, kw = _plan_case(layer, idx)
    k = selftest.KERNELS[kernel]
    bars = (k.tol(torch.bfloat16), k.bf16_ulp_share)
    assert bars == (selftest.K1_TOL, selftest.K1_ULP_SHARE)

    def plain(s):
        return filtered_lrelu_bands.banded_fwd_plain(x[s], fu, fd, **kw)

    if variant == "f32_stages":
        other = filtered_lrelu_bands.banded_fwd_plain(x.float(), fu, fd, **kw).bfloat16()
    else:
        other = filtered_lrelu_composed(x.float(), fu, fd, None, **kw).bfloat16()
    check = selftest._against_plain(name, other, torch.bfloat16, plain, *bars)
    assert not check.ok and check.ulp_share > 10 * selftest.K1_ULP_SHARE, check
    check = selftest._against_plain(name, plain(slice(None)), torch.bfloat16, plain, *bars)
    assert check.ok and check.ulp_share == 0.0, check


@pytest.mark.parametrize("variant", ["f32_stages", "w_first"])
@pytest.mark.parametrize("idx", selftest.KERNEL_LAYERS)
def test_k1_bars_refuse_unrounded_stages(idx, variant, plan_layers):
    """K1's bf16 bars tell the stage-rounded function from the ones it must
    not compute, at each bf16 plan layer."""
    _ulp_bars_refuse_unrounded_stages("K1", idx, variant, plan_layers)


@pytest.mark.parametrize("variant", ["f32_stages", "w_first"])
@pytest.mark.parametrize("idx", selftest.KERNEL_LAYERS)
def test_k3a_bar_refuses_unrounded_stages(idx, variant, plan_layers):
    """K3a's bf16 bars, K1's pair, tell it from the same functions at each
    bf16 plan layer, L3's and L10's crops included."""
    _ulp_bars_refuse_unrounded_stages("K3a", idx, variant, plan_layers)


def _exact_case(layer, idx, frames=2, planes=4):
    """A plan layer's seeded bias-added bf16 input on `frames` frames of
    `planes` planes, its filters and keyword arguments (ToRGB: gain 1, slope
    1)."""
    g = torch.Generator().manual_seed(70 + idx)
    x, fu, fd, kw = selftest._layer_inputs(layer, frames, torch.bfloat16, torch.device("cpu"), g)
    return x[:, :planes].contiguous(), fu, fd, kw


@pytest.mark.parametrize("idx", [4, 6, 8, 9, 11, 12, 14])
@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_exact_bf16_bar_refuses_stage_rounding(kernel, idx, plan_layers):
    """K4's and K5's bf16 bar (EXACT_F32_TOL of the scale beyond half a bf16
    ulp of each element) at each bf16 plan layer they serve, on 2 frames of 4
    planes: the f32 plain value rounded once passes it, with nothing beyond
    half an ulp; the products with bf16 stages (K3a's function,
    `banded_fwd_plain` in bf16) fail it at every layer that resamples,
    though they pass TOLS[bf16], the bar it replaced. At L14 (ToRGB:
    identity operators, gain 1, slope 1) every stage is exact in bf16, so
    the two are one function and both pass."""
    name, layer = plan_layers[idx]
    x, fu, fd, kw = _exact_case(layer, idx)
    k = selftest.KERNELS[kernel]
    tol = k.tol(torch.bfloat16)
    assert k.bf16_half_ulp and k.f32_reference and tol == selftest.EXACT_F32_TOL

    def plain(s):
        return k.plain(x[s].float(), fu, fd, **kw)

    def check(out):
        return selftest._against_plain(name, out, torch.bfloat16, plain, tol, half_ulp=True)

    once = plain(slice(None)).bfloat16()
    c = check(once)
    assert c.ok and c.beyond_half_ulp_rel_err == 0.0, c
    staged = filtered_lrelu_bands.banded_fwd_plain(x, fu, fd, **kw)
    c = check(staged)
    if idx == 14:
        assert torch.equal(staged, once) and c.ok, c
    else:
        assert not c.ok and c.beyond_half_ulp_rel_err > 100 * tol, c
        assert c.rel_err <= selftest.TOLS[torch.bfloat16], c


def _k2_bars(x, dy, fu, fd, kw):
    """selftest's K2 bars as `_against_plain` arguments, the plain version and
    the act' flip bound of a slice."""
    def plain(s):
        return filtered_lrelu_bands.banded_bwd_plain(x[s], dy[s], fu, fd, **kw)

    def flip_bound(s):
        return filtered_lrelu_bands.act_flip_bound(x[s], dy[s], fu, fd, **kw,
                                                   near=selftest.FLIP_NEAR)

    return dict(plain=plain, tol=selftest.KERNELS["K2"].tol(torch.bfloat16),
                flip_bound=flip_bound)


@pytest.mark.parametrize("idx", selftest.KERNEL_LAYERS)
def test_k2_bars_refuse_unrounded_stages(idx, plan_layers):
    """K2's bf16 bars refuse the same products with f32 stages at each bf16
    plan layer on 8 planes (through the share of elements more than one bf16
    ulp of the scale off), and the plain version passes them exactly."""
    name, layer = plan_layers[idx]
    x, dy, fu, fd, kw = _plan_case(layer, idx)
    bars = _k2_bars(x, dy, fu, fd, kw)
    other = filtered_lrelu_bands.banded_bwd_plain(x.float(), dy.float(), fu, fd, **kw)
    check = selftest._against_plain(name, other.bfloat16(), torch.bfloat16, **bars)
    assert not check.ok and check.over_share > 10 * selftest.K2_OVER_SHARE, check
    check = selftest._against_plain(name, bars["plain"](slice(None)), torch.bfloat16, **bars)
    assert check.ok and check.over == 0 and check.beyond_flips_rel_err == 0.0, check


def _bwd_with_flips(x, dy, fu, fd, up, down, padding, gain, slope, clamp, near):
    """`banded_bwd_plain` with act' taken on the other side of its jump at
    every U within `near` * max|t1| * max|Bu| of 0: the most a summation
    order could flip."""
    (au, bu, ad, bd), stage = filtered_lrelu_bands._plain_setup(x, fu, fd, up, down, padding)
    n, c, h, w = x.shape
    t1 = stage(au @ x.reshape(n * c, h, w).float())
    u = t1 @ bu.T
    near_zero = u.abs() < near * t1.abs().amax((1, 2), keepdim=True) * bu.abs().max()
    g = torch.where(near_zero, -u, u)
    g = filtered_lrelu_bands.act_grad(torch.where(g == 0, -1.0, g), gain, slope, clamp)
    s1 = stage(ad.T @ dy.reshape(n * c, *dy.shape[2:]).float())
    dt1 = stage(stage((s1 @ bd) * g) @ bu)
    return (au.T @ dt1).to(x.dtype).reshape(n, c, h, w)


@pytest.mark.parametrize("idx", [3, 4, 8, 12])
def test_act_flip_bound_covers_flips(idx, plan_layers):
    """With act' flipped at every U the bound admits, dX moves past the
    tight bar, and the move stays within the flip bound: the error beyond it
    passes K2_RESIDUAL_TOL (up 4 with a crop at L3, up 2 at the others)."""
    name, layer = plan_layers[idx]
    x, dy, fu, fd, kw = _plan_case(layer, idx)
    flipped = _bwd_with_flips(x, dy, fu, fd, **kw, near=selftest.FLIP_NEAR)
    check = selftest._against_plain(name, flipped, torch.bfloat16, **_k2_bars(x, dy, fu, fd, kw))
    assert check.rel_err > selftest.K2_RESIDUAL_TOL, check
    assert check.beyond_flips_rel_err <= selftest.K2_RESIDUAL_TOL, check
    assert check.over_in_reach == check.over > 0, check


@pytest.mark.parametrize("kernel", ["K2", "K3b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_only_backward_on_cpu_is_the_contraction(kernel, dtype, plan_layers):
    """K2's and K3b's check-only launch (dX, U per tile, the tile setup) on
    a CPU tensor is the tile contraction at its own U at the kernel's tile,
    counts no launch, and lays U out [tiles, planes, rp, rp]; its dX agrees
    with the plain version's."""
    name, layer = plan_layers[4]
    x, dy, fu, fd, kw = _plan_case(layer, 4)
    x, dy = x.to(dtype), dy.to(dtype)
    k = selftest.KERNELS[kernel]
    _reset_counts()
    dx, u, (plan, widths, taps) = k.launch_u(x, dy, fu, fd, **kw)
    assert _counts() == (0,) * 6 and dx.dtype == dtype and u.dtype == torch.float32
    tile = filtered_lrelu_fused.tile_for(True, dtype, 2) if kernel == "K3b" else 32
    assert plan == filtered_lrelu_cuda.bwd_tile_setup(x, fu, fd, kw["up"], kw["down"],
                                                     kw["padding"], tile)[0]
    planes = x.shape[0] * x.shape[1]
    assert u.shape == (math.prod(filtered_lrelu_bands.tile_counts(*x.shape[2:], tile)), planes,
                       plan.rp, plan.rp)
    flat = x.reshape(planes, *x.shape[2:]), dy.reshape(planes, *dy.shape[2:])
    want = filtered_lrelu_bands.tiled_bwd_plain(*flat, plan, widths, taps, kw["gain"],
                                                kw["slope"], kw["clamp"], u=u)
    assert torch.equal(dx, want.reshape(x.shape))
    plain = filtered_lrelu_bands.banded_bwd_plain(x, dy, fu, fd, **kw).float()
    tol = 1e-5 if dtype == torch.float32 else 2 ** -8
    assert (dx.float() - plain).abs().max() <= tol * plain.abs().max()


def test_kernel_entry_rejects_cpu_tensor():
    x, _ = _inputs()
    with pytest.raises(ValueError, match="CUDA tensor"):
        filtered_lrelu_cuda.filtered_lrelu_fwd_cuda(x, FU, FU, 2, 2, 9, 1.4, 0.2, None)
    dy = torch.zeros((2, 3, 12, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        filtered_lrelu_cuda.filtered_lrelu_bwd_cuda(x, dy, FU, FU, 2, 2, 9, 1.4, 0.2, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_gradient_never_launches(dtype):
    """On a CPU tensor the Function's backward is the plain version: the
    stage-rounded banded products that "fused" computes there too, bias
    gradient included."""
    x, b = _inputs(dtype)
    x.requires_grad_(True)
    b.requires_grad_(True)
    kw = dict(up=2, down=2, padding=(9, 8, 9, 8), clamp=4.0)
    _reset_counts()
    y = filtered_lrelu(x, FU, FU, b, impl="packed", **kw)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)).to(dtype)
    got = torch.autograd.grad(y, [x, b], dy)
    want = torch.autograd.grad(filtered_lrelu(x, FU, FU, b, impl="fused", **kw), [x, b], dy)
    assert _counts() == (0,) * 6 and _f32_counts() == (0, 0)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


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
    _reset_counts()
    filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="packed")
    assert _f32_counts() == (1, 0) and filtered_lrelu_cuda.launches == 0
    filtered_lrelu(x, None, None, None, up=1, down=1, impl="packed")    # identity resample
    filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="conv")
    assert _f32_counts() == (1, 0) and filtered_lrelu_cuda.launches == 0


@pytest.mark.cuda
def test_kernel_refuses_gradient(cuda_device):
    """A first-order gradient runs K2; a second-order one is refused."""
    x = torch.randn((1, 2, 12, 16), device=cuda_device, requires_grad=True)
    _reset_counts()
    y = filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="packed")
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert _f32_counts() == (1, 1) and filtered_lrelu_cuda.bwd_launches == 0
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.autograd.grad(g.square().sum(), x)
    with torch.no_grad():
        y = filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="packed")
    assert not y.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("idx", selftest.KERNEL_LAYERS)
def test_bwd_kernel_matches_plain_bf16(idx, cuda_device, plan_layers):
    name, layer = plan_layers[idx]
    gen = torch.Generator().manual_seed(200 + idx)
    check = selftest.check_layer(layer, name, TRAIN_FRAMES, torch.bfloat16, cuda_device, gen,
                                 kernel="K2")
    assert check.ok, check


@pytest.mark.cuda
@pytest.mark.parametrize("idx", [0, 3])
def test_bwd_kernel_matches_plain_f32(idx, cuda_device, plan_layers):
    name, layer = plan_layers[idx]
    gen = torch.Generator().manual_seed(300 + idx)
    check = selftest.check_layer(layer, name, TRAIN_FRAMES, torch.float32, cuda_device, gen,
                                 kernel="K2")
    assert check.ok, check


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,frames", [("K1", 16), ("K1", TRAIN_FRAMES), ("K2", 16),
                                           ("K2", TRAIN_FRAMES)])
@pytest.mark.parametrize("idx", [0, 1, 2])
def test_f32_kernels_match_plain_at_the_heads(idx, kernel, frames, cuda_device, plan_layers):
    """The f32 kernels at the head layers L0-L2 (31x38 maps, up 2: one block
    a plane), at a segment's 16 frames and a training micro-batch's 64."""
    name, layer = plan_layers[idx]
    gen = torch.Generator().manual_seed(600 + idx)
    check = selftest.check_layer(layer, name, frames, torch.float32, cuda_device, gen,
                                 kernel=kernel)
    assert check.ok, check


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_f32_kernels_match_plain_on_a_large_plane(kernel, cuda_device):
    """The f32 kernels on L10's 94x150 maps (up 4, a top crop) in f32: too
    large for one block, so 32x32 tiles (16x16 for the backward), as before
    the tile followed the plane."""
    layer = selftest.plan_layers(num_fp16_res=0)[10][1]
    gen = torch.Generator().manual_seed(610)
    check = selftest.check_layer(layer, "L10", 2, torch.float32, cuda_device, gen,
                                 kernel=kernel)
    assert check.ok, check


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 13, 17), (1, 2, 38, 31), (2, 3, 31, 38),
                                   (1, 1, 70, 33)])
def test_f32_kernels_at_small_odd_and_tiled_planes(shape, cuda_device):
    """The f32 kernels on planes that take one block each (13x17, 38x31, the
    heads' 31x38) or several (70x33 passes the one-block budget: 32x32
    tiles), against the plain versions."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(shape, generator=g).to(cuda_device)
    kw = dict(up=2, down=2, padding=9, gain=1.41, slope=0.2, clamp=4.0)
    y = filtered_lrelu_cuda.filtered_lrelu_fwd_cuda(x, FU, FU, **kw)
    dy = torch.randn(y.shape, generator=g).to(cuda_device)
    dx = filtered_lrelu_cuda.filtered_lrelu_bwd_cuda(x, dy, FU, FU, **kw)
    with selftest.tf32_off():
        plain = (filtered_lrelu_bands.banded_fwd_plain(x, FU, FU, **kw),
                 filtered_lrelu_bands.banded_bwd_plain(x, dy, FU, FU, **kw))
    for got, want in zip((y, dx), plain):
        err = (got - want).abs().max().item()
        assert err <= selftest.TOLS[torch.float32] * want.abs().max().item(), err


@pytest.mark.cuda
def test_f32_launches_count_apart_from_k1_k2(cuda_device):
    """f32 maps count in f32_launches / f32_bwd_launches and never in
    launches / bwd_launches, which count the tensor-core K1 / K2 (bf16 maps)
    alone: the benchmark reads those as K1's and K2's launches."""
    for dtype, want in ((torch.float32, ((0, 0), (1, 1))), (torch.bfloat16, ((1, 1), (0, 0)))):
        x = torch.randn((1, 2, 12, 16), device=cuda_device).to(dtype).requires_grad_(True)
        _reset_counts()
        y = filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="packed")
        torch.autograd.grad(y.float().square().sum(), x)
        assert _counts()[:2] == want[0] and _f32_counts() == want[1], dtype


TENSOR_CORE_PAIRS = {
    "K1/K2": (filtered_lrelu_cuda.filtered_lrelu_fwd_cuda,
              filtered_lrelu_cuda.filtered_lrelu_bwd_cuda),
    "K3a/K3b": (filtered_lrelu_fused.fused_fwd_cuda, filtered_lrelu_fused.fused_bwd_cuda),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernels,dtype", [("K1/K2", torch.bfloat16),
                                           ("K3a/K3b", torch.bfloat16),
                                           ("K3a/K3b", torch.float32)])
@pytest.mark.parametrize("shape", [(2, 3, 12, 16), (1, 2, 13, 17), (1, 1, 70, 33)])
def test_tensor_core_kernels_at_small_and_odd_sizes(shape, kernels, dtype, cuda_device):
    """The tensor-core K1/K2 and K3a/K3b at maps smaller than a tile and of
    odd widths (bf16 patches load element by element there) against their
    plain versions."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g).to(cuda_device, dtype)
    kw = dict(up=2, down=2, padding=9, gain=1.41, slope=0.2, clamp=4.0)
    fwd, bwd = TENSOR_CORE_PAIRS[kernels]
    y = fwd(x, FU, FU, **kw)
    dy = torch.randn(y.shape, generator=g).to(cuda_device, dtype)
    dx = bwd(x, dy, FU, FU, **kw)
    f32 = dtype == torch.float32
    for got, want, tol in ((y, filtered_lrelu_bands.banded_fwd_plain(x, FU, FU, **kw),
                            selftest.EXACT_F32_TOL if f32 else selftest.K1_TOL),
                           (dx, filtered_lrelu_bands.banded_bwd_plain(x, dy, FU, FU, **kw),
                            selftest.TOLS[dtype])):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_bwd_kernel_rejects_bad_input(cuda_device):
    x = torch.randn((1, 2, 12, 16), device=cuda_device)
    dy = torch.randn((1, 2, 12, 16), device=cuda_device)
    with pytest.raises(TypeError):
        filtered_lrelu_cuda.filtered_lrelu_bwd_cuda(x, dy.bfloat16(), FU, FU, 2, 2, 9, 1.4,
                                                    0.2, None)
    with pytest.raises(ValueError, match="dy shape"):
        filtered_lrelu_cuda.filtered_lrelu_bwd_cuda(x, dy[:, :, :5].contiguous(), FU, FU, 2, 2,
                                                    9, 1.4, 0.2, None)


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


def _small_layer():
    return "small", SynthesisLayer(**LAYER_KW, resample_impl="auto")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,frames", [("K3a", 16), ("K3b", TRAIN_FRAMES)])
@pytest.mark.parametrize("where", ["small", "L0", "L1", "L2", "L3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_match_plain(kernel, frames, where, dtype, cuda_device, plan_layers):
    """K3a and K3b at a small up-2 geometry, at the f32 head layers L0-L2
    (31x38, up 2) and at L3 (31x38, up 4, a crop: the geometry that once
    miscompiled on the TPU), each in f32 (three-part products) and bf16."""
    name, layer = _small_layer() if where == "small" else plan_layers[int(where[1:])]
    gen = torch.Generator().manual_seed(400)
    check = selftest.check_layer(layer, name, frames, dtype, cuda_device, gen, kernel=kernel)
    assert check.ok, check


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K4", "K5"])
@pytest.mark.parametrize("where", ["small", "L0", "L4", "L14"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_only_kernels_match_plain(kernel, where, dtype, cuda_device, plan_layers):
    """K4 and K5 (f32 bar EXACT_F32_TOL; bf16 EXACT_F32_TOL beyond half an
    ulp of each element) at a small up-2 geometry, at L0 (31x38, up 2, the
    f32 head), L4 (40x54, up 2) and L14 (ToRGB: up 1, down 1, no filters, 3
    channels at 144x256), each in both types."""
    name, layer = _small_layer() if where == "small" else plan_layers[int(where[1:])]
    gen = torch.Generator().manual_seed(500)
    check = selftest.check_layer(layer, name, 16, dtype, cuda_device, gen, kernel=kernel)
    assert check.ok, check


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_at_up_4(dtype, cuda_device, plan_layers):
    """K4 at L3's 31x38 maps and filters (up 4, down 2) with a top crop the
    JAX kernel takes (py0 = -3 > -up): no plan layer gives K4 up 4, but its
    entry takes it, and up 4 is where the TPU kernel once miscompiled."""
    name, layer = plan_layers[3]
    layer = copy.copy(layer)
    layer.padding = [-6, -9, -3, -9]
    gen = torch.Generator().manual_seed(501)
    check = selftest.check_layer(layer, name, 16, dtype, cuda_device, gen, kernel="K4")
    assert check.ok, check


@pytest.mark.cuda
def test_fused_entry_launches_k3_and_refuses_second_order(cuda_device):
    x = torch.randn((1, 2, 12, 16), device=cuda_device, requires_grad=True)
    _reset_counts()
    y = filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="fused")
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert _counts() == (0, 0, 1, 1, 0, 0)
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.autograd.grad(g.square().sum(), x)
    filtered_lrelu(x, None, None, None, impl="fused")            # identity resample
    assert _counts() == (0, 0, 1, 1, 0, 0)


@pytest.mark.cuda
def test_forward_only_entries_launch_and_refuse_gradients(cuda_device):
    x = torch.randn((1, 2, 12, 16), device=cuda_device, requires_grad=True)
    _reset_counts()
    y4 = filtered_lrelu(x, FU, FU, None, up=2, down=2, padding=9, impl="pallas")
    y5 = filtered_lrelu_polyphase.filtered_lrelu_pallas_v2(x, FU, FU, None, up=2, down=2,
                                                            padding=9)
    assert _counts() == (0, 0, 0, 0, 1, 1)
    for y in (y4, y5):
        with pytest.raises(NotImplementedError, match="forward-only"):
            torch.autograd.grad(y.sum(), x)
    for entry in ("pallas", "pallas_v2"):
        with pytest.raises(ValueError, match="py0"):
            ENTRIES[entry](x, FU, FU, None, up=2, down=2, padding=(9, 8, -2, 8))
    assert _counts() == (0, 0, 0, 0, 1, 1)
