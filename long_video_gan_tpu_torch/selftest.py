"""On-card check of the filtered_lrelu kernel against its plain version at
the layer geometries of the 144x256 sres plan.

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
from .ops.filtered_lrelu import filtered_lrelu_composed

# Max-abs error relative to max|reference|. bf16: a few bf16 ulps, since the
# input and output round to bf16 and the kernel sums in f32 (the bar of
# scripts/tpu_selftest.py); f32: summation order only.
TOLS = {torch.bfloat16: 0.03, torch.float32: 1e-4}

# The bf16 layers of the 144x256 plan that launch the kernel (L14, ToRGB, is
# an identity resample and takes the composed path).
KERNEL_LAYERS = tuple(range(3, 14))


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


def check_layer(layer: SynthesisLayer, name: str, frames: int, dtype: torch.dtype,
                device: torch.device, generator: torch.Generator,
                time_it: bool = False) -> LayerCheck:
    """Kernel (through its wrapper) against the plain f32 version on one
    layer's geometry; optionally times both in `dtype` with CUDA events."""
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

    with torch.no_grad():
        out = filtered_lrelu_cuda.filtered_lrelu_packed(x, fu, fd, b, **kw)
        xb = x + b.reshape(1, -1, 1, 1)
        with tf32_off():
            ref = filtered_lrelu_composed(xb.float(), fu, fd, None, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        scale = ref.abs().max().item() or 1.0
        check = LayerCheck(name=name, shape=tuple(out.shape), dtype=str(dtype).split(".")[-1],
                           max_abs_err=err, rel_err=err / scale,
                           ok=out.shape == ref.shape and out.dtype == dtype
                           and err <= TOLS[dtype] * scale)
        if time_it:
            check.ms = _time_ms(lambda: filtered_lrelu_cuda.filtered_lrelu_fwd_cuda(
                xb, fu, fd, **kw))
            check.plain_ms = _time_ms(lambda: filtered_lrelu_composed(xb, fu, fd, None, **kw))
    return check
