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
# K2 and K3b: act' jumps at U = 0, so where another summation order puts a
# U near 0 on the other side, dX moves by up to a few hundredths of its scale
# (the H100 read 4.42e-2 at K3b's L9 in bf16 and 1.5e-2 at L0-L1 in f32
# against the plain version). A max-abs bar on the raw error would have to
# admit that; so their check-only builds write U per tile, as act' takes it
# (`filtered_lrelu_cuda.bwd_u_cuda`), and the tile contraction
# (`filtered_lrelu_bands.tiled_bwd_plain`) is held to the kernel at exactly
# those decisions:
# (i)   every element of the kernel's U within the reach another summation
#       order has of the contraction's own U (`tiled_u_reach`): in bf16
#       FLIP_NEAR * max|t1| * max|Bu| per plane (one t1 rounded the other
#       way), in f32 (n + m + 8) * 2**-24 * (|Au| . |X| . |Bu|^T). A wrong
#       tap, padding, window or plane fails here; the sign disagreements,
#       which (i) confines to U within that reach of 0, are counted;
# (ii)  the kernel's dX against the contraction's with act' at the kernel's
#       U: in bf16 at K1's two bars (K1_TOL of the scale, K1_ULP_SHARE of
#       the elements beyond one ulp of their own), in f32 at TOLS[f32] of the
#       scale at every element;
# (iii) the check-only launch's dX bit-equal to the production launch's.
# Per tile, not per map position: neighbouring tiles recompute overlapping
# windows, each in its own summation order. (i)-(iii) replace, for K2 and
# K3b in bf16, the raw TOLS[bf16] bar (the raw error stays a reading) and,
# for K3b in f32, the greedy attribution of flips that stood there before.
# In bf16 K2's bars beyond flips stay besides: the error beyond the most such
# flips can move each element (`filtered_lrelu_bands.act_flip_bound` over the
# U within FLIP_NEAR) within one bf16 ulp of the scale, and at most
# K2_OVER_SHARE of the elements more than one bf16 ulp of the scale off (the
# H100 reads at most 2e-8, every such element within reach of a U near 0;
# f32 stages put fifty times the bar or more there). K2 on f32 maps is
# csrc/filtered_lrelu_bwd.cu, which has no U to show: TOLS[f32] on the raw
# error.
FLIP_NEAR = 2.0 ** -7
K2_RESIDUAL_TOL = 2.0 ** -7
K2_OVER_SHARE = 1e-5

# The bf16 layers of the 144x256 plan that launch K1/K2 (L14, ToRGB, is an
# identity resample and takes the composed path).
KERNEL_LAYERS = tuple(range(3, 14))
# The f32 kernels (csrc/filtered_lrelu_{fwd,bwd}.cu, on the plan's f32 head
# layers L0-L2 under "auto") under their own names, as their launch counters
# keep them apart from the tensor-core K1/K2, and the KERNELS entry that runs
# and checks each (the wrapper picks the kernel by dtype).
F32_KERNELS = {"K1f32": "K1", "K2f32": "K2"}

# Frames per slice of the plain reference: at a training micro-batch (64
# frames) the reference of an up-4 layer would not fit the card at once.
REF_FRAMES = 16
# Frames per chunk of the tile contraction inside a slice: it holds several
# [tiles, planes, rp, rp] f32 stages (3.1 GB each at L10 and 8 frames).
TILE_FRAMES = 8

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
    launch_u: Optional[Callable] = None      # check-only launch: dX, U per tile, setup (K2, K3b)
    tile_dtypes: tuple = ()                  # map types held at their own act' decisions
    f32_reference: bool = True
    f32_tol: float = TOLS[torch.float32]
    bf16_tol: float = TOLS[torch.bfloat16]
    f32_arithmetic: bool = False
    bf16_ulp_share: Optional[float] = None   # K1_ULP_SHARE's bar in bf16 (K1, K3a)
    bf16_flip_bars: bool = False             # K2's bars beyond act' flips in bf16 (K2, K3b)
    bf16_half_ulp: bool = False              # bf16 tol beyond half an ulp per element (K4, K5)
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
           filtered_lrelu_cuda.filtered_lrelu_bwd_u_cuda, (torch.bfloat16,),
           f32_reference=False, bf16_flip_bars=True),
    Kernel("K3a", False, filtered_lrelu_fused.fused_fwd_cuda, _bands.banded_fwd_plain,
           f32_reference=False, f32_tol=EXACT_F32_TOL, bf16_tol=K1_TOL,
           bf16_ulp_share=K1_ULP_SHARE, split_f32=True),
    Kernel("K3b", True, filtered_lrelu_fused.fused_bwd_cuda, _bands.banded_bwd_plain,
           filtered_lrelu_fused.fused_bwd_u_cuda, (torch.bfloat16, torch.float32),
           f32_reference=False, bf16_flip_bars=True, split_f32=True),
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
    the bf16 layers that resample (impl "auto"); K1f32/K2f32 (F32_KERNELS)
    the f32 layers that resample (impl "auto"); K3a/K3b every layer that
    resamples (impl "fused"); K4 every layer whose top padding the JAX kernel
    takes (py0 > -up); K5 those of K4 with up and down in {1, 2}."""
    out = []
    for i, (_, layer) in enumerate(layers):
        up, down = layer.up_factor, layer.down_factor
        resamples = not (up == down == 1 and layer.up_filter is None
                         and layer.down_filter is None)
        takes_padding = layer.padding[2] > -up
        if ((kernel in ("K1", "K2") and resamples and layer.use_fp16)
                or (kernel in F32_KERNELS and resamples and not layer.use_fp16)
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
    # K2/K3b at their own act' decisions (`_against_tiles`): (i) the largest
    # |U_kernel - U_tiles| as a share of its reach, the U elements, the U
    # where the two take opposite signs and the U within reach of 0; (ii) dX
    # against the contraction at the kernel's U (relative max-abs, its bar,
    # bf16: the share of elements beyond one ulp of their own); (iii) the
    # check-only launch's dX bit-equal to the production one (None: no
    # launch, a CPU tensor).
    u_reach_share: Optional[float] = None
    u_elements: Optional[int] = None
    u_signs: Optional[int] = None
    u_near: Optional[int] = None
    tiles_rel_err: Optional[float] = None
    tiles_tol: Optional[float] = None
    tiles_ulp_share: Optional[float] = None
    dump_equal: Optional[bool] = None

    @property
    def over_share(self) -> float:
        return self.over / self.elements


def describe(kernel: str, check: LayerCheck, extra: str = "") -> str:
    """One check as a line: the error against the plain version and its bar
    (a reading only, for K2/K3b at their own act' decisions), `extra`, then
    the readings a gradient's bars hold."""
    tol = "reading" if check.u_reach_share is not None else f"tol {check.tol:g}"
    line = (f"{kernel} {check.name:<16} {check.dtype:<8} out {check.shape} rel_err "
            f"{check.rel_err:.2e} ({tol}){extra}")
    if check.over is not None:
        line += (f" beyond act' flips {check.beyond_flips_rel_err:.2e} (tol "
                 f"{check.flip_tol:g}), off by > {check.flip_tol:g} {check.over} of "
                 f"{check.elements} ({check.over_share:.2e}, tol {K2_OVER_SHARE:g}), "
                 f"{check.over_in_reach} of them within reach of a U near 0 (all elements: "
                 f"{check.reach_share:.3%})")
    if check.u_reach_share is not None:
        line += (f"; at its own act' decisions: U off by {check.u_reach_share:.3f} of its "
                 f"reach at most (tol 1), signs apart at {check.u_signs} of the "
                 f"{check.u_near} U within reach of 0 ({check.u_elements} U), dX "
                 f"{check.tiles_rel_err:.2e} (tol {check.tiles_tol:g})")
        if check.tiles_ulp_share is not None:
            line += (f", off by > 1 ulp {check.tiles_ulp_share:.2e} of the elements (tol "
                     f"{K1_ULP_SHARE:g})")
        line += f", check-only launch bit-equal: {check.dump_equal}"
    return f"{line} {'ok' if check.ok else 'FAIL'}"


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
                   flip_tol: float = K2_RESIDUAL_TOL, half_ulp: bool = False,
                   raw_bar: bool = True) -> LayerCheck:
    """`out` (the kernel's, launched once at full size) against `plain(s)`,
    the plain version (TF32 off) of the frames in slice `s`, computed
    REF_FRAMES frames at a time so that its memory stays bounded at training
    size; error and scale are the maxima over the slices. `ulp_share_tol`:
    also bars the share of elements more than one bf16 ulp of their own off.
    `flip_bound(s)`: the act' flip bound of slice s; then K2's bars beyond it
    apply too (`flip_tol`, K2_OVER_SHARE), with `out`'s own scale as the
    scale of the elements counted off. `half_ulp`: `tol` bars, in place of
    the error itself, each element's error beyond half a bf16 ulp of its own
    reference (an f32 value rounded once to bf16 is within that). Without
    `raw_bar` the error itself is a reading only (K2/K3b, whose
    `_against_tiles` bars stand in its place)."""
    err = scale = beyond = past_half_ulp = 0.0
    ref_frames, ref_rest = 0, None
    n_ulp = n_over = n_over_reach = n_reach = 0
    over_at = flip_tol * out.abs().max().float().item()
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
                if flip_bound is not None:
                    e = flip_bound(s)
                    beyond = max(beyond, (d - e).max().item())
                    over, reach = d > over_at, e > 0
                    n_over += int(over.sum())
                    n_over_reach += int((over & reach).sum())
                    n_reach += int(reach.sum())
                    del e, over, reach
                del d
            else:
                err = math.inf
            del ref
    scale = scale or 1.0
    check = LayerCheck(name=name, shape=tuple(out.shape), dtype=str(dtype).split(".")[-1],
                       max_abs_err=err, rel_err=err / scale, tol=tol,
                       ok=tuple(out.shape) == (ref_frames,) + ref_rest and out.dtype == dtype
                       and (not raw_bar or half_ulp or err <= tol * scale))
    if half_ulp:
        check.beyond_half_ulp_rel_err = max(past_half_ulp, 0.0) / scale
        check.ok = check.ok and check.beyond_half_ulp_rel_err <= tol
    if ulp_share_tol is not None:
        check.ulp_share = n_ulp / out.numel()
        check.ok = check.ok and check.ulp_share <= ulp_share_tol
    if flip_bound is not None:
        check.flip_tol, check.beyond_flips_rel_err = flip_tol, beyond / scale
        check.over, check.over_in_reach, check.elements = n_over, n_over_reach, out.numel()
        check.reach_share = n_reach / out.numel()
        check.ok = (check.ok and check.beyond_flips_rel_err <= flip_tol
                    and check.over_share <= K2_OVER_SHARE)
    return check


def _against_tiles(check: LayerCheck, out: torch.Tensor, x: torch.Tensor, dy: torch.Tensor,
                   launch_u: Callable, fu, fd, **kw) -> LayerCheck:
    """Bars (i)-(iii) of K2/K3b (the comment at FLIP_NEAR) on `check`, the
    kernel's production dX `out` at bias-added `x` along `dy`: `launch_u`
    (check-only: dX, U per tile and the tile setup) on REF_FRAMES-frame
    slices, the tile contraction on TILE_FRAMES-frame chunks of each, TF32
    off. On a CPU tensor `launch_u` is the contraction itself and (iii) is
    not read."""
    bf16 = x.dtype == torch.bfloat16
    gain, slope, clamp = kw["gain"], kw["slope"], kw["clamp"]
    planes = x.shape[1]
    worst_u = err = scale = 0.0
    n_u = n_signs = n_near = n_ulp = 0
    equal = None if x.device.type == "cpu" else True
    with tf32_off():
        for s in _slices(x.shape[0]):
            dx_u, u, (plan, widths, taps) = launch_u(x[s], dy[s], fu, fd, **kw)
            if equal is not None:
                equal = equal and torch.equal(dx_u, out[s])
            del dx_u
            for c0 in range(0, x[s].shape[0], TILE_FRAMES):
                c = slice(c0, c0 + TILE_FRAMES)
                xc, dyc = x[s][c], dy[s][c]
                xp = xc.reshape(-1, *xc.shape[2:])
                uk = u[:, c0 * planes:c0 * planes + xp.shape[0]]
                ref, own = _bands.tiled_bwd_plain(xp, dyc.reshape(-1, *dyc.shape[2:]), plan,
                                                  widths, taps, gain, slope, clamp, u=uk,
                                                  return_u=True)
                reach = _bands.tiled_u_reach(xp, plan, widths, taps, FLIP_NEAR).expand_as(own)
                du = (uk - own).abs()
                share = torch.where(reach > 0, du / reach.clamp_min(1e-38),
                                    torch.where(du > 0, math.inf, 0.0))
                worst_u = max(worst_u, share.max().item())
                n_u += own.numel()
                n_signs += int(((uk >= 0) != (own >= 0)).sum())
                n_near += int((own.abs() <= reach).sum())
                del du, share, reach, own
                ref = ref.float().reshape(xc.shape)
                d = (out[s][c].float() - ref).abs()
                err = max(err, d.max().item())
                scale = max(scale, ref.abs().max().item())
                if bf16:
                    n_ulp += int((d > bf16_ulp(ref)).sum())
                del d, ref
            del u
    scale = scale or 1.0
    check.u_reach_share, check.u_elements, check.u_signs, check.u_near = (
        worst_u, n_u, n_signs, n_near)
    check.tiles_tol = K1_TOL if bf16 else TOLS[torch.float32]
    check.tiles_rel_err, check.dump_equal = err / scale, equal
    ok = worst_u <= 1.0 and check.tiles_rel_err <= check.tiles_tol and equal is not False
    if bf16:
        check.tiles_ulp_share = n_ulp / out.numel()
        ok = ok and check.tiles_ulp_share <= K1_ULP_SHARE
    check.ok = check.ok and ok
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
    K5 to their bar beyond half an ulp. K2 and K3b in the types of
    `tile_dtypes` are held at their own act' decisions (`_against_tiles`)
    in place of a bar on the raw error. A CPU tensor runs the plain version
    against itself."""
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
    own_decisions = dtype in k.tile_dtypes
    with torch.no_grad():
        out = k.run(*args, fu, fd, **kw)
        check = _against_plain(name, out, dtype, lambda s: k.plain(
            *(ref(a[s]) for a in args), fu, fd, **kw), k.tol(dtype),
            k.bf16_ulp_share if bf16 else None, half_ulp=bf16 and k.bf16_half_ulp,
            raw_bar=not own_decisions, **bars)
        if own_decisions:
            _against_tiles(check, out, *args, k.launch_u, fu, fd, **kw)
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

