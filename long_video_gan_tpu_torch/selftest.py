"""On-card check of the filtered_lrelu kernels (K1 forward, K2 backward)
against their plain versions at the layer geometries of the 144x256 sres plan.

Counterpart of `scripts/tpu_selftest.py`: filters, paddings and factors come
from the port's own `SynthesisLayer`s, with `frames` x `out_channels` planes.
The reference is the plain composed path computed in f32 (TF32 off) from the
same input. Used by `chip_smoke.py` and `tests/test_torch_filtered_lrelu_cuda.py`,
so the two hold the kernel to the same cases and bars.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import torch

from .models.generator_sres import SynthesisLayer, SynthesisNetwork
from .ops import filtered_lrelu_cuda
from .ops.filtered_lrelu import filtered_lrelu_composed, output_size

# Max-abs error relative to max|reference|. bf16: a few bf16 ulps, since the
# input and output round to bf16 and the kernel sums in f32 (the bar of
# scripts/tpu_selftest.py); f32: summation order only.
TOLS = {torch.bfloat16: 0.03, torch.float32: 1e-4}

# The bf16 layers of the 144x256 plan that launch the kernel (L14, ToRGB, is
# an identity resample and takes the composed path).
KERNEL_LAYERS = tuple(range(3, 14))

# Frames per slice of the f32 reference: at a training micro-batch (64
# frames) the reference of an up-4 layer would not fit the card at once.
REF_FRAMES = 16


def plan_layers(img_width: int = 256, img_height: int = 144, channel_max: int = 512,
                num_fp16_res: int = 4) -> list[tuple[str, SynthesisLayer]]:
    """(name, layer) for every SynthesisLayer of the sres plan, built on the
    CPU: only their geometry and filters are used."""
    net = SynthesisNetwork(w_dim=16, img_width=img_width, img_height=img_height,
                           img_channels=3, cond_channels=27, channel_max=channel_max,
                           num_fp16_res=num_fp16_res)
    return list(zip(net.layer_names, net.layers))


@dataclasses.dataclass
class LayerCheck:
    name: str
    shape: tuple           # kernel output shape
    dtype: str
    max_abs_err: float
    rel_err: float
    ok: bool
    ms: Optional[float] = None
    plain_ms: Optional[float] = None


@contextlib.contextmanager
def tf32_off():
    """Full-f32 cuDNN convolutions and matmuls inside the block (cuDNN uses
    TF32 by default on the card); the previous flags come back after it."""
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _against_plain(name: str, out: torch.Tensor, dtype: torch.dtype, plain) -> LayerCheck:
    """`out` (the kernel's, launched once at full size) against `plain(s)`,
    the f32 plain version (TF32 off) of the frames in slice `s`, computed
    REF_FRAMES frames at a time so that its memory stays bounded at training
    size; error and scale are the maxima over the slices."""
    err = scale = 0.0
    ref_frames, ref_rest = 0, None
    with tf32_off():
        for start in range(0, out.shape[0], REF_FRAMES):
            s = slice(start, start + REF_FRAMES)
            ref = plain(s)
            ref_frames += ref.shape[0]
            ref_rest = tuple(ref.shape[1:])
            if tuple(out[s].shape) == tuple(ref.shape):
                err = max(err, (out[s].float() - ref).abs().max().item())
                scale = max(scale, ref.abs().max().item())
            else:
                err = math.inf
            del ref
    scale = scale or 1.0
    return LayerCheck(name=name, shape=tuple(out.shape), dtype=str(dtype).split(".")[-1],
                      max_abs_err=err, rel_err=err / scale,
                      ok=tuple(out.shape) == (ref_frames,) + ref_rest and out.dtype == dtype
                      and err <= TOLS[dtype] * scale)


def _layer_inputs(layer: SynthesisLayer, frames: int, dtype: torch.dtype,
                  device: torch.device, generator: torch.Generator):
    """Seeded input x and bias b of one layer's filtered_lrelu, its filters on
    `device`, and its keyword arguments."""
    h = layer.in_size[1] + layer.kernel - 1
    w = layer.in_size[0] + layer.kernel - 1
    c = layer.out_channels
    x = torch.randn((frames, c, h, w), generator=generator, device=generator.device)
    x = x.to(device=device, dtype=dtype)
    b = torch.randn((c,), generator=generator, device=generator.device).to(device=device,
                                                                            dtype=dtype)
    fu = layer.up_filter.to(device)
    fd = layer.down_filter.to(device)
    kw = dict(up=layer.up_factor, down=layer.down_factor, padding=layer.padding,
              gain=math.sqrt(2.0), slope=0.2, clamp=layer.conv_clamp)
    return x, b, fu, fd, kw


def check_layer(layer: SynthesisLayer, name: str, frames: int, dtype: torch.dtype,
                device: torch.device, generator: torch.Generator,
                time_it: bool = False) -> LayerCheck:
    """Kernel (through its wrapper) against the plain f32 version on one
    layer's geometry, `frames` x out_channels planes; optionally times both in
    `dtype` with CUDA events, each at full size."""
    x, b, fu, fd, kw = _layer_inputs(layer, frames, dtype, device, generator)

    with torch.no_grad():
        out = filtered_lrelu_cuda.filtered_lrelu_packed(x, fu, fd, b, **kw)
        xb = x + b.reshape(1, -1, 1, 1)
        check = _against_plain(name, out, dtype, lambda s: filtered_lrelu_composed(
            xb[s].float(), fu, fd, None, **kw))
        if time_it:
            check.ms = _time_ms(lambda: filtered_lrelu_cuda.filtered_lrelu_fwd_cuda(
                xb, fu, fd, **kw))
            check.plain_ms = _time_ms(lambda: filtered_lrelu_composed(xb, fu, fd, None, **kw))
    return check


def check_layer_bwd(layer: SynthesisLayer, name: str, frames: int, dtype: torch.dtype,
                    device: torch.device, generator: torch.Generator,
                    time_it: bool = False) -> LayerCheck:
    """K2 (through its wrapper) against its plain version, the autograd
    gradient of the composed op in f32 (TF32 off), on one layer's geometry
    and a seeded output gradient; optionally times both in `dtype`."""
    x, b, fu, fd, kw = _layer_inputs(layer, frames, dtype, device, generator)
    xb = x + b.reshape(1, -1, 1, 1)
    out_shape = (xb.shape[0], xb.shape[1]) + output_size(
        xb.shape[2], xb.shape[3], fu, fd, kw["up"], kw["down"], kw["padding"])
    dy = torch.randn(out_shape, generator=generator, device=generator.device)
    dy = dy.to(device=device, dtype=dtype)

    dx = filtered_lrelu_cuda.filtered_lrelu_bwd_cuda(xb, dy, fu, fd, **kw)
    check = _against_plain(name, dx, dtype, lambda s: (
        filtered_lrelu_cuda.filtered_lrelu_bwd_plain(xb[s].float(), dy[s].float(), fu, fd,
                                                     **kw)))
    if time_it:
        check.ms = _time_ms(lambda: filtered_lrelu_cuda.filtered_lrelu_bwd_cuda(
            xb, dy, fu, fd, **kw))
        check.plain_ms = _time_ms(lambda: filtered_lrelu_cuda.filtered_lrelu_bwd_plain(
            xb, dy, fu, fd, **kw))
    return check
