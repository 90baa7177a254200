"""The yardstick's arithmetic: peaks of the card, operations and bytes.

Copies of the program's sound counts, applied to the reference models so
that the number does not depend on what implements a layer:
`segment_flops` (`long_video_gan_tpu_torch/bench.py`), `filtered_lrelu_macs`
and `bound` (`long_video_gan_tpu_torch/selftest.py`), and `count_flops`, the
dense convolutions and matrix products that a call and its gradients run.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .reference.ops import upfirdn2d_macs

# NVIDIA H100 SXM, dense, 700 W (NVIDIA's data sheet).
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES_PER_S = 3.35e12


def filtered_lrelu_macs(layer, backward: bool = False) -> tuple[int, int, int]:
    """(out_h, out_w, multiply-adds per plane) of a synthesis layer's
    filtered_lrelu, tap-exact (up pass H first, down pass W first); the
    input gradient costs twice the forward."""
    h = layer.in_size[1] + layer.kernel - 1
    w = layer.in_size[0] + layer.kernel - 1
    fu = 1 if layer.up_filter is None else layer.up_filter.shape[0]
    fd = 1 if layer.down_filter is None else layer.down_filter.shape[0]
    hu, wu, up_macs = upfirdn2d_macs(h, w, fu, up=layer.up_factor, padding=layer.padding)
    ho, wo, down_macs = upfirdn2d_macs(hu, wu, fd, down=layer.down_factor, h_first=False)
    return ho, wo, (up_macs + down_macs) * (2 if backward else 1)


def bound_s(layer, frames: int, dtype: torch.dtype, backward: bool) -> float:
    """The least seconds the card could take for one layer's filtered_lrelu
    (or its input gradient) on frames x out_channels planes: the larger of
    its operations at the dense peak of `dtype` and each map byte read or
    written once at the HBM peak."""
    h = layer.in_size[1] + layer.kernel - 1
    w = layer.in_size[0] + layer.kernel - 1
    ho, wo, macs = filtered_lrelu_macs(layer, backward)
    planes = frames * layer.out_channels
    item = torch.finfo(dtype).bits // 8
    maps = h * w + ho * wo + (h * w if backward else 0)
    peak = PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_F32
    return max(2 * macs * planes / peak, maps * item * planes / PEAK_BYTES_PER_S)


def hand_kernel_layers(G) -> list:
    """The synthesis layers whose filtered_lrelu K1/K2 serve on the sres
    path (resample_impl "auto"): the bfloat16 layers that resample (L3-L13
    of the 144x256 plan; L14's 1x1 torgb takes the composed path)."""
    return [layer for layer in G.SG3.synthesis.layers
            if layer.use_fp16 and not (layer.up_factor == layer.down_factor == 1
                                       and layer.up_filter is None
                                       and layer.down_filter is None)]


def segment_flops(G, segment: int = 16, batch: int = 1) -> dict[str, int]:
    """Operations of one sres G call on `batch` videos of `segment` output
    frames, two per multiply-add, from the layer plan: the modulated convs
    (conditioning channels in Cin), the mapping network, affines and
    demodulation, each filtered_lrelu and the conditioning pyramid's
    resamplers, tap-exact; elementwise work left out."""
    sg3 = G.SG3
    frames = batch * segment
    net, mapping = sg3.synthesis, sg3.mapping
    matmul = sum(2 * getattr(mapping, f"fc{i}").weight.numel()
                 for i in range(mapping.num_layers)) * batch
    conv = fir = 0
    for layer in net.layers:
        k, cin, cout = layer.kernel, layer.in_channels, layer.out_channels
        h, w = layer.in_size[1] + k - 1, layer.in_size[0] + k - 1
        conv += 2 * cout * cin * k * k * h * w * frames
        matmul += 2 * layer.affine.weight.numel() * frames
        if not layer.is_torgb:
            matmul += 2 * cout * cin * frames
        fir += 2 * filtered_lrelu_macs(layer)[2] * cout * frames
    lr_planes = sg3.img_channels * batch * (segment + 2 * G.temporal_context)
    edge = max(G.lr_width, G.lr_height) + 2 * sg3.margin_size
    for resample in sg3.resamplers.values():
        if not isinstance(resample, torch.nn.Identity):
            fir += 2 * resample.macs(edge, edge) * lr_planes
    return {"conv": conv, "matmul": matmul, "fir": fir}


def flops_per_frame(G, segment: int = 16) -> float:
    return sum(segment_flops(G, segment).values()) / segment


# ---------------------------------------------------------------------------
# Dense operations of a training step, counted while it runs on the meta
# device.

_aten = torch.ops.aten


class DenseFlops(TorchDispatchMode):
    """Counts the operations of the dense convolutions and matrix products
    dispatched inside it, two per multiply-add: forward, input gradient
    and weight gradient each as computed. Depthwise convolutions (the FIR
    resamplers, groups equal to the input channels) are left out."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in (_aten.mm, _aten.bmm):
            a, b = args[0], args[1]
            self.flops += 2 * a.numel() * b.shape[-1]
        elif packet in (_aten.addmm, _aten.baddbmm):
            a, b = args[1], args[2]
            self.flops += 2 * a.numel() * b.shape[-1]
        elif packet == _aten.convolution:
            x, w, groups = args[0], args[1], args[8]
            if not _depthwise(x, groups):
                assert not args[6], "transposed convolutions are not counted"
                self.flops += _conv_flops(out, w)
        elif packet == _aten.convolution_backward:
            grad_out, x, w = args[0], args[1], args[2]
            groups, mask = args[9], args[10]
            if not _depthwise(x, groups):
                assert not args[7], "transposed convolutions are not counted"
                self.flops += _conv_flops(grad_out, w) * (int(mask[0]) + int(mask[1]))
        return out


def _depthwise(x: torch.Tensor, groups: int) -> bool:
    return groups > 1 and groups == x.shape[1]


def _conv_flops(out: torch.Tensor, w: torch.Tensor) -> int:
    """2 * output elements * (Cin / groups) * kernel taps."""
    return 2 * out.numel() * w.shape[1] * math.prod(w.shape[2:])


def count_flops(fn: Callable[[], None]) -> int:
    """The dense operations that `fn` dispatches (run it on meta tensors)."""
    with DenseFlops() as mode:
        fn()
    return mode.flops
