"""On-card check of the filtered_lrelu kernels against their plain versions at
the layer geometries of the 144x256 sres plan: K1 forward and K2 backward
(`impl="packed"`), K3a forward and K3b backward (`impl="fused"`), K4
(`impl="pallas"`) and K5 (`filtered_lrelu_pallas_v2`).

Counterpart of `scripts/tpu_selftest.py`: filters, paddings and factors come
from the port's own `SynthesisLayer`s, with `frames` x `out_channels` planes.
Each kernel's reference is its plain version on the same input, computed
with TF32 off: for K1-K3b in the input's type, whose bf16 stage rounding is
part of their function (`filtered_lrelu_bands.py`), and in f32 for K4 and K5,
which round only their output.
Timings are in the input's type. Used by `chip_smoke.py`
and `tests/test_torch_filtered_lrelu_cuda.py`, so the two hold the kernels to
the same cases and bars.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional

import torch

from .models.generator_sres import SynthesisLayer, SynthesisNetwork
from .ops import (filtered_lrelu_bands, filtered_lrelu_cuda, filtered_lrelu_exact,
                  filtered_lrelu_fused, filtered_lrelu_polyphase)
from .ops.filtered_lrelu import filtered_lrelu_composed, output_size
from .ops.upfirdn2d import parse_padding, upfirdn2d_macs

# Max-abs error relative to max|reference|. bf16: a few bf16 ulps, since the
# input and output round to bf16 and the kernel sums in f32 (the bar of
# scripts/tpu_selftest.py); f32: summation order only. EXACT_F32_TOL, the f32
# bar of K3a, K4 and K5, is the JAX kernels' own claim of f32 exactness (2e-7
# against the f32 oracle): three-part bf16 products meet it, and a single
# bf16 or TF32 pass does not, nor K3b's f32 bars below
# (tests/test_torch_packed_tiles.py).
TOLS = {torch.bfloat16: 0.03, torch.float32: 1e-4}
EXACT_F32_TOL = 1e-6
# K4 and K5 in bf16: f32 stages, the output rounded once. Each element is
# held within half a bf16 ulp of its own f32 reference (one rounding), plus
# EXACT_F32_TOL of the scale (the f32 error before it): the bar is
# EXACT_F32_TOL on the error beyond half an ulp. bf16 stages (K3a's function)
# land 3.9e-3 to 1.0e-2 of the scale away at the plan's resampling layers,
# inside TOLS[bf16], and fail it (tests/test_torch_filtered_lrelu_cuda.py).
# K1 and K3a in bf16: max-abs within one bf16 ulp of the output's scale. They
# round the same stages as their plain version, but sum each band in
# tensor-core order, so a rounding flips now and then and carries through the
# later stages. That bar alone would pass the products with f32 stages (or
# the W pass first), so besides, at most K1_ULP_SHARE of the elements may lie
# more than one bf16 ulp of their own from the plain version. The H100 reads
# about 1e-6 at the plan's bf16 layers; f32 stages put a hundred times the
# bar there (tests/test_torch_filtered_lrelu_cuda.py).
K1_TOL = 2.0 ** -7
K1_ULP_SHARE = 1e-4
# K2 and K3b in bf16: act' jumps at U = 0, so where another summation order
# puts a U near 0 on the other side, dX moves by up to a few hundredths of its
# scale (the bar of TOLS). Held besides: the error beyond the most such flips
# can move each element (`filtered_lrelu_bands.act_flip_bound` over the U
# within FLIP_NEAR) within one bf16 ulp of the scale, and at most
# K2_OVER_SHARE of the elements more than one bf16 ulp of the scale off (the
# H100 reads at most 2e-8, every such element within reach of a U near 0;
# f32 stages put fifty times the bar or more there).
FLIP_NEAR = 2.0 ** -7
K2_RESIDUAL_TOL = 2.0 ** -7
K2_OVER_SHARE = 1e-5
# K3b in f32: the same jump. Its tensor-core products sum in another order
# than the plain version's f32 matmuls, so a U within f32 rounding of 0 can
# take the other side of it, and dX moves there by up to a few hundredths of
# its scale (the H100 read up to 1.5e-2 at L0-L1 over 64 frames, at 24 and 40
# of their 3.9e7 elements). So K3b in f32 is held to TOLS[f32] at every
# element after the moves of witnessed flips are taken out: a flip counts
# only at a U that f64 puts within f32 rounding of 0, and only where the
# error has that flip's own shape and sign
# (`filtered_lrelu_bands.act_flip_witness`).

# The bf16 layers of the 144x256 plan that launch K1/K2 (L14, ToRGB, is an
# identity resample and takes the composed path).
KERNEL_LAYERS = tuple(range(3, 14))

# Frames per slice of the plain reference: at a training micro-batch (64
# frames) the reference of an up-4 layer would not fit the card at once.
REF_FRAMES = 16

# The card's published dense peaks (NVIDIA H100 SXM data sheet, 700 W, no
# sparsity): bf16 products on the tensor cores, f32 outside them, and HBM.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# f32 products on the tensor cores as K3a/K3b (f32 maps) and K4/K5 (either
# map type) take them: six bf16 passes per product, so a sixth of the bf16
# peak.
SPLIT_F32_FLOPS = PEAK_FLOPS[torch.bfloat16] / 6
PEAK_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One kernel: its launch on the card and its plain version, both
    `(x, fu, fd, **kw)` on bias-added x (`(x, dy, fu, fd, **kw)` for a
    backward). The reference of a check is the plain version on the inputs
    cast to f32 where `f32_reference`, else on the inputs as they are.
    `f32_arithmetic`: the function computes in f32 whatever the maps' type,
    as three-part bf16 products on the tensor cores (K4, K5)."""

    name: str
    backward: bool
    launch: Callable
    plain: Callable
    f32_reference: bool = True
    f32_tol: float = TOLS[torch.float32]
    bf16_tol: float = TOLS[torch.bfloat16]
    f32_arithmetic: bool = False
    bf16_ulp_share: Optional[float] = None   # K1_ULP_SHARE's bar in bf16 (K1, K3a)
    bf16_flip_bars: bool = False             # K2's bars beyond act' flips in bf16 (K2, K3b)
    bf16_half_ulp: bool = False              # bf16 tol beyond half an ulp per element (K4, K5)
    f32_flip_witness: bool = False           # f32 bar beyond witnessed act' flips (K3b)
    split_f32: bool = False                  # f32 maps as three-part bf16 products (K3a, K3b)

    def tol(self, dtype: torch.dtype) -> float:
        return self.f32_tol if dtype == torch.float32 else self.bf16_tol

    def peak_flops(self, dtype: torch.dtype) -> float:
        """The card's peak for this kernel's products on maps of `dtype`."""
        if self.f32_arithmetic or (dtype == torch.float32 and self.split_f32):
            return SPLIT_F32_FLOPS
        return PEAK_FLOPS[dtype]

    def run(self, *args, **kw) -> torch.Tensor:
        """The kernel on a CUDA tensor, its plain version on a CPU tensor, as
        the wrappers dispatch."""
        return (self.plain if args[0].device.type == "cpu" else self.launch)(*args, **kw)


def _composed(x, fu, fd, **kw):
    return filtered_lrelu_composed(x, fu, fd, None, **kw)


_bands = filtered_lrelu_bands
KERNELS = {k.name: k for k in (
    Kernel("K1", False, filtered_lrelu_cuda.filtered_lrelu_fwd_cuda, _bands.banded_fwd_plain,
           f32_reference=False, bf16_tol=K1_TOL, bf16_ulp_share=K1_ULP_SHARE),
    Kernel("K2", True, filtered_lrelu_cuda.filtered_lrelu_bwd_cuda, _bands.banded_bwd_plain,
           f32_reference=False, bf16_flip_bars=True),
    Kernel("K3a", False, filtered_lrelu_fused.fused_fwd_cuda, _bands.banded_fwd_plain,
           f32_reference=False, f32_tol=EXACT_F32_TOL, bf16_tol=K1_TOL,
           bf16_ulp_share=K1_ULP_SHARE, split_f32=True),
    Kernel("K3b", True, filtered_lrelu_fused.fused_bwd_cuda, _bands.banded_bwd_plain,
           f32_reference=False, bf16_flip_bars=True, f32_flip_witness=True, split_f32=True),
    Kernel("K4", False, filtered_lrelu_exact.exact_fwd_cuda, filtered_lrelu_exact.exact_plain,
           f32_tol=EXACT_F32_TOL, bf16_tol=EXACT_F32_TOL, f32_arithmetic=True,
           bf16_half_ulp=True),
    Kernel("K5", False, filtered_lrelu_polyphase.polyphase_fwd_cuda,
           filtered_lrelu_polyphase.polyphase_plain, f32_tol=EXACT_F32_TOL,
           bf16_tol=EXACT_F32_TOL, f32_arithmetic=True, bf16_half_ulp=True),
)}


def plan_layers(img_width: int = 256, img_height: int = 144, channel_max: int = 512,
                num_fp16_res: int = 4) -> list[tuple[str, SynthesisLayer]]:
    """(name, layer) for every SynthesisLayer of the sres plan, built on the
    CPU: only their geometry and filters are used."""
    net = SynthesisNetwork(w_dim=16, img_width=img_width, img_height=img_height,
                           img_channels=3, cond_channels=27, channel_max=channel_max,
                           num_fp16_res=num_fp16_res)
    return list(zip(net.layer_names, net.layers))


def served_layers(kernel: str, layers: list[tuple[str, SynthesisLayer]]) -> list[int]:
    """The plan layers whose filtered_lrelu runs `kernel` on its path: K1/K2
    the bf16 layers that resample (impl "auto"); K3a/K3b every layer that
    resamples (impl "fused"); K4 every layer whose top padding the JAX kernel
    takes (py0 > -up); K5 those of K4 with up and down in {1, 2}."""
    out = []
    for i, (_, layer) in enumerate(layers):
        up, down = layer.up_factor, layer.down_factor
        resamples = not (up == down == 1 and layer.up_filter is None
                         and layer.down_filter is None)
        takes_padding = layer.padding[2] > -up
        if ((kernel in ("K1", "K2") and resamples and layer.use_fp16)
                or (kernel in ("K3a", "K3b") and resamples)
                or (kernel == "K4" and takes_padding)
                or (kernel == "K5" and takes_padding and up <= 2 and down <= 2)):
            out.append(i)
    return out


def layer_dtype(layer: SynthesisLayer) -> torch.dtype:
    """The type the layer's filtered_lrelu runs in on the sres path."""
    return torch.bfloat16 if layer.use_fp16 else torch.float32


@dataclasses.dataclass
class LayerCheck:
    name: str
    shape: tuple           # kernel output shape
    dtype: str
    max_abs_err: float
    rel_err: float
    ok: bool
    tol: float = 0.0
    ms: Optional[float] = None
    plain_ms: Optional[float] = None
    bound_ms: Optional[float] = None
    bound_by: Optional[str] = None
    composed_rel_err: Optional[float] = None   # against the f32 composed op
    ulp_share: Optional[float] = None   # elements more than one bf16 ulp of their own off
    beyond_half_ulp_rel_err: Optional[float] = None   # K4/K5 bf16: error beyond half an ulp
    # The readings beyond act' flips (K2, K3b): the bar beyond them, the
    # largest error beyond the flip bound (relative), the elements more than
    # that bar of the scale off, how many of those a flip can reach, the share
    # of all elements a flip can reach, and the elements checked.
    flip_tol: Optional[float] = None
    beyond_flips_rel_err: Optional[float] = None
    over: Optional[int] = None
    over_in_reach: Optional[int] = None
    reach_share: Optional[float] = None
    elements: Optional[int] = None
    # K3b in f32 (`act_flip_witness`): the witnessed flips and the U near 0.
    flips: Optional[int] = None
    near_zero: Optional[int] = None

    @property
    def over_share(self) -> float:
        return self.over / self.elements


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


def _slices(frames: int) -> list[slice]:
    return [slice(s, s + REF_FRAMES) for s in range(0, frames, REF_FRAMES)]


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |v| (8 significant bits), 0 at v = 0."""
    return torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8) * (v != 0)


def _against_plain(name: str, out: torch.Tensor, dtype: torch.dtype, plain, tol: float,
                   ulp_share_tol: Optional[float] = None, flip_bound=None,
                   flip_tol: float = K2_RESIDUAL_TOL, witness=None,
                   half_ulp: bool = False) -> LayerCheck:
    """`out` (the kernel's, launched once at full size) against `plain(s)`,
    the plain version (TF32 off) of the frames in slice `s`, computed
    REF_FRAMES frames at a time so that its memory stays bounded at training
    size; error and scale are the maxima over the slices. `ulp_share_tol`:
    also bars the share of elements more than one bf16 ulp of their own off.
    `flip_bound(s)`: the act' flip bound of slice s; then K2's bars beyond it
    apply too (`flip_tol`, K2_OVER_SHARE), with `out`'s own scale as the
    scale of the elements counted off. `witness(s, err)`: (explained, flips,
    near) of `act_flip_witness` on slice s's signed error; then `tol` bars
    the error beyond the witnessed flips at every element, in place of the
    error itself, and the elements more than `tol` of the scale off are
    counted beside those a witnessed flip reaches. `half_ulp`: `tol` bars,
    in place of the error itself, each element's error beyond half a bf16
    ulp of its own reference (an f32 value rounded once to bf16 is within
    that)."""
    err = scale = beyond = past_half_ulp = 0.0
    ref_frames, ref_rest = 0, None
    n_ulp = n_over = n_over_reach = n_reach = n_flips = n_near = 0
    flips_tol = tol if witness is not None else flip_tol
    over_at = flips_tol * out.abs().max().float().item()
    with tf32_off():
        for s in _slices(out.shape[0]):
            ref = plain(s).float()
            ref_frames += ref.shape[0]
            ref_rest = tuple(ref.shape[1:])
            if tuple(out[s].shape) == tuple(ref.shape):
                d = (out[s].float() - ref).abs()
                err = max(err, d.max().item())
                scale = max(scale, ref.abs().max().item())
                if ulp_share_tol is not None:
                    n_ulp += int((d > bf16_ulp(ref)).sum())
                if half_ulp:
                    past_half_ulp = max(past_half_ulp, (d - bf16_ulp(ref) / 2).max().item())
                if witness is not None:
                    signed = out[s].double() - ref.double()
                    explained, flips, near = witness(s, signed)
                    beyond = max(beyond, (signed - explained).abs().max().item())
                    reach = explained != 0
                    n_flips, n_near = n_flips + flips, n_near + near
                    del signed, explained
                elif flip_bound is not None:
                    e = flip_bound(s)
                    beyond = max(beyond, (d - e).max().item())
                    reach = e > 0
                    del e
                if witness is not None or flip_bound is not None:
                    over = d > over_at
                    n_over += int(over.sum())
                    n_over_reach += int((over & reach).sum())
                    n_reach += int(reach.sum())
                    del reach, over
                del d
            else:
                err = math.inf
            del ref
    scale = scale or 1.0
    check = LayerCheck(name=name, shape=tuple(out.shape), dtype=str(dtype).split(".")[-1],
                       max_abs_err=err, rel_err=err / scale, tol=tol,
                       ok=tuple(out.shape) == (ref_frames,) + ref_rest and out.dtype == dtype
                       and (witness is not None or half_ulp or err <= tol * scale))
    if half_ulp:
        check.beyond_half_ulp_rel_err = max(past_half_ulp, 0.0) / scale
        check.ok = check.ok and check.beyond_half_ulp_rel_err <= tol
    if ulp_share_tol is not None:
        check.ulp_share = n_ulp / out.numel()
        check.ok = check.ok and check.ulp_share <= ulp_share_tol
    if witness is not None or flip_bound is not None:
        check.flip_tol, check.beyond_flips_rel_err = flips_tol, beyond / scale
        check.over, check.over_in_reach, check.elements = n_over, n_over_reach, out.numel()
        check.reach_share = n_reach / out.numel()
        check.ok = check.ok and check.beyond_flips_rel_err <= flips_tol
        if witness is not None:
            check.flips, check.near_zero = n_flips, n_near
        else:
            check.ok = check.ok and check.over_share <= K2_OVER_SHARE
    return check


def _layer_inputs(layer: SynthesisLayer, frames: int, dtype: torch.dtype,
                  device: torch.device, generator: torch.Generator):
    """Seeded bias-added input of one layer's filtered_lrelu, its filters on
    `device`, and its keyword arguments."""
    h = layer.in_size[1] + layer.kernel - 1
    w = layer.in_size[0] + layer.kernel - 1
    c = layer.out_channels
    x = torch.randn((frames, c, h, w), generator=generator, device=generator.device)
    x = x.to(device=device, dtype=dtype)
    b = torch.randn((c,), generator=generator, device=generator.device).to(device=device,
                                                                            dtype=dtype)
    fu = None if layer.up_filter is None else layer.up_filter.to(device)
    fd = None if layer.down_filter is None else layer.down_filter.to(device)
    gain, slope = (1.0, 1.0) if layer.is_torgb else (math.sqrt(2.0), 0.2)
    kw = dict(up=layer.up_factor, down=layer.down_factor, padding=layer.padding,
              gain=gain, slope=slope, clamp=layer.conv_clamp)
    return x + b.reshape(1, -1, 1, 1), fu, fd, kw


def filtered_lrelu_macs(layer: SynthesisLayer, backward: bool = False) -> tuple[int, int, int]:
    """(out_h, out_w, multiply-adds per plane) of one layer's filtered_lrelu
    (backward: its input gradient), tap-exact: the up pass H first (t1 =
    Au . X, then U), the down pass W first (t3, then out), each the nonzeros
    of its banded operator times the length of the other axis
    (`upfirdn2d_macs`); the backward runs the six passes of the gradient
    and recomputes U (s1, dZ, dt1, dX): twice the forward. The activation's
    few operations per supersampled value are left out."""
    h = layer.in_size[1] + layer.kernel - 1
    w = layer.in_size[0] + layer.kernel - 1
    fu_taps = 1 if layer.up_filter is None else layer.up_filter.shape[0]
    fd_taps = 1 if layer.down_filter is None else layer.down_filter.shape[0]
    hu, wu, up_macs = upfirdn2d_macs(h, w, fu_taps, up=layer.up_factor, padding=layer.padding)
    ho, wo, down_macs = upfirdn2d_macs(hu, wu, fd_taps, down=layer.down_factor, h_first=False)
    return ho, wo, (up_macs + down_macs) * (2 if backward else 1)


def bound(layer: SynthesisLayer, frames: int, dtype: torch.dtype, backward: bool,
          peak_flops: Optional[float] = None) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take for
    one layer's filtered_lrelu (backward: its input gradient) on `frames` x
    out_channels planes of type `dtype`. Operations: `filtered_lrelu_macs`,
    two each, at `peak_flops` (`Kernel.peak_flops`; default the peak for
    `dtype`: bf16 maps and taps make bf16 products summed in f32, the tensor
    cores' work). Bytes: each input read once, the output written once, at
    the HBM peak."""
    h = layer.in_size[1] + layer.kernel - 1
    w = layer.in_size[0] + layer.kernel - 1
    ho, wo, macs = filtered_lrelu_macs(layer, backward)
    planes = frames * layer.out_channels
    item = torch.finfo(dtype).bits // 8
    maps = h * w + ho * wo + (h * w if backward else 0)
    ops_ms = 2 * macs * planes / (peak_flops or PEAK_FLOPS[dtype]) * 1e3
    bytes_ms = maps * item * planes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def executed_flops(layer: SynthesisLayer, frames: int, kernel: str,
                   dtype: torch.dtype = torch.bfloat16) -> float:
    """Operations the tensor-core K1/K3a/K4/K5 (forward) or K2/K3b (gradient)
    executes on one layer in `dtype`, at the tile its wrapper takes: two per
    multiply-add of every visited 16-wide K-block
    (`filtered_lrelu_bands.fwd_executed_macs`), band zeros included, once per
    partial product: six for three-part operands (f32 maps; K4/K5 on either
    type), three for K4/K5's t1 = Au . X on a bf16 patch."""
    bands, cuda = filtered_lrelu_bands, filtered_lrelu_cuda
    h = layer.in_size[1] + layer.kernel - 1
    w = layer.in_size[0] + layer.kernel - 1
    up, down, pad = layer.up_factor, layer.down_factor, parse_padding(layer.padding)
    k = KERNELS[kernel]
    taps = (up, down, pad, len(bands.filter_taps(layer.up_filter)),
            len(bands.filter_taps(layer.down_filter)))
    parts = 3 if k.f32_arithmetic or dtype == torch.float32 else 1
    x_parts = 1 if dtype == torch.bfloat16 else parts
    tile = filtered_lrelu_fused.tile_for(k.backward, dtype, up) if kernel in (
        "K3a", "K3b") else cuda.TILE
    plan, _, _, where = cuda._tc_plan(k.backward, *taps, torch.device("cpu"), tile)
    widths = {name: ref[3] for name, ref in where.items()}
    hw = (h, w) if k.backward else output_size(h, w, layer.up_filter, layer.down_filter, up,
                                               down, pad)
    tiles = math.prod(bands.tile_counts(*hw, tile)) * frames * layer.out_channels
    if k.backward:
        return 2.0 * bands.partial_products(parts, parts) * bands.bwd_executed_macs(
            plan, widths, tiles)
    return 2.0 * bands.fwd_executed_macs(plan, widths, tiles, parts, x_parts)


def check_layer(layer: SynthesisLayer, name: str, frames: int, dtype: torch.dtype,
                device: torch.device, generator: torch.Generator, time_it: bool = False,
                kernel: str = "K1", vs_composed: bool = False) -> LayerCheck:
    """`kernel` against its plain version (TF32 off) on one layer's geometry,
    `frames` x out_channels planes and, for a backward, a seeded output
    gradient; optionally times the kernel (mean of 10 launches) and the plain
    version (mean of 3, REF_FRAMES frames at a time) in `dtype` with CUDA
    events, and gives the layer's bound. `vs_composed` (a forward): also
    holds the output to the f32 composed op on the input cast to f32, at the
    bf16 bar, the cost of the stage rounding. In bf16, K1 and K3a are also
    held to K1_ULP_SHARE, K2 and K3b to K2's bars beyond act' flips, K4 and
    K5 to their bar beyond half an ulp; K3b is held in f32 to TOLS[f32]
    beyond witnessed act' flips. A CPU tensor runs the plain version against
    itself."""
    k = KERNELS[kernel]
    x, fu, fd, kw = _layer_inputs(layer, frames, dtype, device, generator)
    args = (x,)
    if k.backward:
        out_shape = (x.shape[0], x.shape[1]) + output_size(
            x.shape[2], x.shape[3], fu, fd, kw["up"], kw["down"], kw["padding"])
        dy = torch.randn(out_shape, generator=generator, device=generator.device)
        args = (x, dy.to(device=device, dtype=dtype))

    ref = (lambda a: a.float()) if k.f32_reference else (lambda a: a)
    bf16 = dtype == torch.bfloat16
    bars = {}
    if bf16 and k.bf16_flip_bars:
        bars["flip_bound"] = lambda s: filtered_lrelu_bands.act_flip_bound(
            *(a[s] for a in args), fu, fd, **kw, near=FLIP_NEAR)
    if not bf16 and k.f32_flip_witness:
        bars["witness"] = lambda s, err: filtered_lrelu_bands.act_flip_witness(
            *(a[s] for a in args), err, fu, fd, **kw)
    with torch.no_grad():
        out = k.run(*args, fu, fd, **kw)
        check = _against_plain(name, out, dtype, lambda s: k.plain(
            *(ref(a[s]) for a in args), fu, fd, **kw), k.tol(dtype),
            k.bf16_ulp_share if bf16 else None, half_ulp=bf16 and k.bf16_half_ulp, **bars)
        if vs_composed:
            composed = _against_plain(name, out, dtype, lambda s: _composed(
                x[s].float(), fu, fd, **kw), TOLS[torch.bfloat16])
            check.composed_rel_err = composed.rel_err
            check.ok = check.ok and composed.ok
        if time_it:
            check.ms = _time_ms(lambda: k.run(*args, fu, fd, **kw))
            check.plain_ms = _time_ms(lambda: [k.plain(*(a[s] for a in args), fu, fd, **kw)
                                               for s in _slices(frames)], iters=3)
            check.bound_ms, check.bound_by = bound(layer, frames, dtype, k.backward,
                                                   peak_flops=k.peak_flops(dtype))
    return check

