"""filtered_lrelu as four banded operator products, per plane X:

    out = Ad . act(Au . X . Bu^T) . Bd^T
    dX  = Au^T . (act'(U) * (Ad^T . dY . Bd)) . Bu,   U = Au . X . Bu^T

with the banded per-axis operators of `operators`. This is the function of
the JAX package's packed and fused Pallas kernels
(`long_video_gan_tpu/ops/pallas/filtered_lrelu_packed.py` `_packed_fwd`,
`_packed_bwd`; `filtered_lrelu_fused.py` `_fused_fwd`, `_fused_bwd`): the
products in this order, with the TPU kernels' stores between them. For bf16
maps the operators, t1 = Au . X, Z = act(U) and t3 = Z . Bd^T (backward: t1,
s1 = Ad^T . dY, dU and dt1 = dU . Bu) round to bf16, and every sum is f32;
f32 maps stay in f32 throughout, so there the products equal the composed op
to summation order.

`banded_fwd_plain` and `banded_bwd_plain` are the plain versions of K1/K2
(`filtered_lrelu_cuda.py`) and K3a/K3b (`filtered_lrelu_fused.py`).
`fwd_tile_plan` and `bwd_tile_plan` are the tile operators of the bf16
tensor-core kernels of K1 and K2 (csrc/filtered_lrelu_tc.cu): for a tile of
T outputs (dX) per axis, the blocks of Au, Ad (Ad^T, Au^T) that every tile
of a layer reads, and the 16-wide K-windows of their bands.
`tiled_fwd_plain` and `tiled_bwd_plain` contract those plans tile by tile,
as the kernels do; `tiled_bwd_plain` can take act' from a kernel's own U
(`selftest` holds K2 and K3b to it there).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from .upfirdn2d import Filter, as_filter_tensor, axis_matrix, parse_padding


@functools.lru_cache(maxsize=256)
def operators(h: int, w: int, up: int, down: int, padding: tuple, fu_taps: tuple,
              fd_taps: tuple):
    """The four banded f32 [out, in] operators Au, Bu, Ad, Bd on the CPU. The
    per-axis gain is `up`, so that the two up passes compose to up**2."""
    px0, px1, py0, py1 = padding
    fu = torch.tensor(fu_taps, dtype=torch.float32)
    fd = torch.tensor(fd_taps, dtype=torch.float32)
    au = axis_matrix(fu, h, up, 1, py0, py1, False, float(up))
    bu = axis_matrix(fu, w, up, 1, px0, px1, False, float(up))
    ad = axis_matrix(fd, au.shape[0], 1, down, 0, 0, False, 1.0)
    bd = axis_matrix(fd, bu.shape[0], 1, down, 0, 0, False, 1.0)
    return au, bu, ad, bd


def filter_taps(f: Filter) -> tuple:
    """A separable filter's taps as a tuple of floats (None: one tap)."""
    f = as_filter_tensor(f, torch.device("cpu"))
    if f.numel() != 1 and f.ndim != 1:
        raise ValueError(f"the filtered_lrelu kernels take separable (1-D) filters, "
                         f"got shape {tuple(f.shape)}")
    return tuple(f.reshape(-1).tolist())


def _plain_setup(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int, padding):
    """The operators on x's device, their entries rounded to the maps' type
    (as the TPU kernel holds them) and held in f32, and the stage rounding."""
    ops = operators(x.shape[2], x.shape[3], up, down, parse_padding(padding), filter_taps(fu),
                    filter_taps(fd))
    ops = [m.to(device=x.device, dtype=x.dtype).float() for m in ops]
    return ops, lambda t: t.to(x.dtype).float()


def bf16_parts(t: torch.Tensor, parts: int) -> list:
    """`parts` bf16 tensors whose sum is f32 `t` (to 2**-24 of it for 3
    parts): each the rounding of what the ones before it leave. One part is
    t's bf16 rounding; three (hi, mid, lo) hold its f32 value, as the
    tensor-core kernels hold f32 operands (csrc/filtered_lrelu_tc.cuh)."""
    out = []
    for _ in range(parts):
        out.append(t.to(torch.bfloat16))
        t = t - out[-1].float()
    return out


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the f32 tensor-core kernels compute it: both in three bf16
    parts, the six partial products above 2**-24 summed in f32, hi . hi
    apart from the other five."""
    (ah, am, al), (bh, bm, bl) = ([p.float() for p in bf16_parts(t, 3)] for t in (a, b))
    return ah @ bh + (am @ bm + ah @ bl + al @ bh + ah @ bm + am @ bh)


def act(u: torch.Tensor, gain: float, slope: float, clamp: Optional[float]) -> torch.Tensor:
    z = torch.where(u >= 0, u, u * slope) * gain
    return z if clamp is None else z.clamp(-clamp, clamp)


def act_grad(u: torch.Tensor, gain: float, slope: float,
             clamp: Optional[float]) -> torch.Tensor:
    g = torch.where(u >= 0, gain, gain * slope)
    if clamp is not None:
        zg = torch.where(u >= 0, u, u * slope) * gain
        g = torch.where((zg > -clamp) & (zg < clamp), g, 0.0)
    return g


def banded_fwd_plain(x: torch.Tensor, fu: Filter, fd: Filter, up: int, down: int, padding,
                     gain: float, slope: float, clamp: Optional[float]) -> torch.Tensor:
    """The forward on bias-added NCHW `x`, stages rounded to x's type."""
    (au, bu, ad, bd), stage = _plain_setup(x, fu, fd, up, down, padding)
    n, c, h, w = x.shape
    t1 = stage(au @ x.reshape(n * c, h, w).float())
    z = stage(act(t1 @ bu.T, gain, slope, clamp))
    t3 = stage(z @ bd.T)
    out = (ad @ t3).to(x.dtype)
    return out.reshape(n, c, out.shape[1], out.shape[2])


def banded_bwd_plain(x: torch.Tensor, dy: torch.Tensor, fu: Filter, fd: Filter, up: int,
                     down: int, padding, gain: float, slope: float,
                     clamp: Optional[float]) -> torch.Tensor:
    """dX at bias-added NCHW `x` along `dy`, U recomputed, stages rounded to
    x's type."""
    (au, bu, ad, bd), stage = _plain_setup(x, fu, fd, up, down, padding)
    n, c, h, w = x.shape
    t1 = stage(au @ x.reshape(n * c, h, w).float())
    g = act_grad(t1 @ bu.T, gain, slope, clamp)
    s1 = stage(ad.T @ dy.reshape(n * c, *dy.shape[2:]).float())
    du = stage((s1 @ bd) * g)
    dt1 = stage(du @ bu)
    return (au.T @ dt1).to(x.dtype).reshape(n, c, h, w)


def act_flip_bound(x: torch.Tensor, dy: torch.Tensor, fu: Filter, fd: Filter, up: int,
                   down: int, padding, gain: float, slope: float, clamp: Optional[float],
                   near: float) -> torch.Tensor:
    """Per element of `banded_bwd_plain`'s dX, the most it moves if act'
    takes the other side of its jump at every U within `near` * max|t1| *
    max|Bu| of 0 (max|t1| per plane): (1 - slope) * gain * |Au|^T . |dZ| .
    |Bu| over those U, in f32. A t1 rounded the other way moves U by at most
    2**-7 * max|t1| * max|Bu|, so with `near` = 2**-7 this covers the sign
    flips that another summation order can make."""
    (au, bu, ad, bd), stage = _plain_setup(x, fu, fd, up, down, padding)
    n, c, h, w = x.shape
    t1 = stage(au @ x.reshape(n * c, h, w).float())
    u = t1 @ bu.T
    delta = near * t1.abs().amax((1, 2), keepdim=True) * bu.abs().max()
    dz = (stage(ad.T @ dy.reshape(n * c, *dy.shape[2:]).float()) @ bd).abs()
    dz = torch.where(u.abs() < delta, dz, 0.0)
    return (abs(1.0 - slope) * gain * (au.abs().T @ dz @ bu.abs())).reshape(n, c, h, w)


# ---------------------------------------------------------------------------
# Tile plans of the tensor-core kernels.
#
# A tile's supersampled window starts at a multiple of `up` (forward: T*down
# is a multiple of up; backward: T*up a multiple of down), so the block of
# each operator that a tile reads is the same for every tile of a layer: the
# host builds it once, and the kernel zero-fills its patches outside the map.
# Patch starts are even, so that bf16 pairs of a row load as 4-byte words.

MMA_K = 16   # K-step (and M rows) of mma.m16n8k16


def _pad16(n: int) -> int:
    return -(-n // MMA_K) * MMA_K


def smem_ld(cols: int) -> int:
    """Row stride (elements) of a bf16 tile in shared memory: a multiple of 8
    (16-byte rows for ldmatrix) whose 16-byte count is odd, so the eight rows
    of an 8x8 fragment fall in distinct banks."""
    return _pad16(cols) + 8


def _even_floor(v: int) -> int:
    return v - (v % 2)


def band_windows(index: torch.Tensor) -> tuple:
    """For each 16-row block of a stored operator [rows, K], the 16-wide
    K-blocks [k0, k1) that hold its nonzeros ((0, 0) for none)."""
    out = []
    for r0 in range(0, index.shape[0], MMA_K):
        nz = torch.nonzero((index[r0:r0 + MMA_K] >= 0).any(0)).flatten()
        out.append((0, 0) if nz.numel() == 0 else
                   (int(nz.min()) // MMA_K, int(nz.max()) // MMA_K + 1))
    return tuple(out)


def _up_block(nfu: int, up: int, pad0: int, rows: int, rows_pad: int, r0: int, base: int,
              cols_pad: int) -> torch.Tensor:
    """Tap indices of a [rows_pad, cols_pad] block of Au: window row j
    (supersampled r0 + j, j < rows) reads patch column p (input base + p)
    through tap k = (base + p)*up + pad0 - r0 - j of fu (flipped, times up);
    -1 for a zero."""
    j = torch.arange(rows_pad)[:, None]
    p = torch.arange(cols_pad)[None, :]
    k = (base + p) * up + pad0 - r0 - j
    return torch.where((k >= 0) & (k < nfu) & (j < rows), k, -1)


def _down_block(nfu: int, nfd: int, down: int, rows: int, r0: int, base: int, cols_pad: int,
                cols: int) -> torch.Tensor:
    """Tap indices of a [rows, cols_pad] block of Ad: output row t (at base +
    t) reads window column j (< cols, supersampled r0 + j) through tap
    r0 + j - (base + t)*down of fd (flipped), stored after fu's; -1 for a
    zero."""
    t = torch.arange(rows)[:, None]
    j = torch.arange(cols_pad)[None, :]
    k = r0 + j - (base + t) * down
    return torch.where((k >= 0) & (k < nfd) & (j < cols), nfu + k, -1)


@dataclasses.dataclass(frozen=True)
class AxisOp:
    """One axis's operator block as tap indices ([rows, K], rows a multiple
    of 16, -1 for a zero) and its band K-windows per 16-row block."""
    index: torch.Tensor
    windows: tuple

    @property
    def ld(self) -> int:
        return smem_ld(self.index.shape[1])

    @property
    def kb(self) -> int:
        """The widest band window, in K-blocks."""
        return max(1, max(k1 - k0 for k0, k1 in self.windows))

    def kernel_windows(self, kb: int) -> list[tuple[int, int]]:
        """The windows as the kernels walk them: `kb` blocks each (unrolled),
        from the band's first block, kept inside the operator's K; the extra
        blocks meet zeros of the operator."""
        last = self.index.shape[1] // MMA_K - kb
        if last < 0:
            raise ValueError(f"a band window of {kb} K-blocks exceeds the operator's "
                             f"{self.index.shape[1]} columns")
        return [(min(k0, last), min(k0, last) + kb) for k0, _ in self.windows]

    def values(self, taps: torch.Tensor) -> torch.Tensor:
        """The block's f32 entries from `taps` = [fu flipped times up, fd
        flipped] (`filtered_lrelu_cuda.kernel_geometry`)."""
        return torch.cat([taps, taps.new_zeros(1)])[self.index.to(taps.device)]


def _axis_op(index: torch.Tensor) -> AxisOp:
    return AxisOp(index, band_windows(index))


@dataclasses.dataclass(frozen=True)
class FwdAxis:
    """Forward tile geometry of one axis: tile t's outputs start at t*T, its
    window of `rows` supersampled rows at t*T*down, its input patch at
    t*step + base (`patch` rows, padded to 16 in the plan)."""
    rows: int
    base: int
    patch: int
    au: torch.Tensor          # [RP, PP]: window row <- patch row
    ad: torch.Tensor          # [T, RP]: output row <- window row


def _fwd_axis(tile: int, up: int, down: int, pad0: int, nfu: int, nfd: int, rp: int,
              pp: Optional[int]) -> FwdAxis:
    rows = (tile - 1) * down + nfd
    i_min = -(pad0 // up)                                  # ceil(-pad0 / up)
    i_max = (rows - 1 - pad0 + nfu - 1) // up
    base = _even_floor(i_min)
    patch = i_max - base + 1
    pp = pp or _pad16(patch)
    return FwdAxis(rows, base, patch, _up_block(nfu, up, pad0, rows, rp, 0, base, pp),
                   _down_block(nfu, nfd, down, tile, 0, 0, rp, rows))


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """K1's tile plan: T x T output tiles; per axis (y, x) the blocks of Au
    and Ad; RP window rows and PP patch rows, both padded to 16."""
    tile: int
    step: int                 # patch start advance per tile: T*down/up
    rp: int
    pp: int
    y: FwdAxis
    x: FwdAxis
    ops: dict                 # "au_y", "au_x", "ad_y", "ad_x" -> AxisOp


@functools.lru_cache(maxsize=256)
def fwd_tile_plan(tile: int, up: int, down: int, padding: tuple, nfu: int,
                  nfd: int) -> FwdPlan:
    """K1's plan for T = `tile` and filters of nfu and nfd taps; raises unless
    T*down is a multiple of up."""
    if (tile * down) % up or tile % MMA_K:
        raise ValueError(f"filtered_lrelu tile {tile}: T*down ({tile * down}) must be a "
                         f"multiple of up ({up}) and T of {MMA_K}")
    px0, _, py0, _ = padding
    rp = _pad16((tile - 1) * down + nfd)
    pp = max(_pad16(_fwd_axis(tile, up, down, p, nfu, nfd, rp, None).patch) for p in (py0, px0))
    ay = _fwd_axis(tile, up, down, py0, nfu, nfd, rp, pp)
    ax = _fwd_axis(tile, up, down, px0, nfu, nfd, rp, pp)
    ops = {"au_y": _axis_op(ay.au), "au_x": _axis_op(ax.au),
           "ad_y": _axis_op(ay.ad), "ad_x": _axis_op(ax.ad)}
    return FwdPlan(tile, tile * down // up, rp, pp, ay, ax, ops)


@dataclasses.dataclass(frozen=True)
class BwdAxis:
    """Backward tile geometry of one axis: tile t's dX rows start at t*T, its
    window of `rows` supersampled rows at t*T*up + r0, its x patch at
    t*T + x_base, its dy patch at t*dstep + d_base."""
    rows: int
    r0: int
    x_base: int
    x_patch: int
    d_base: int
    d_patch: int
    au: torch.Tensor          # [RP, PX]: window row <- x patch row
    adt: torch.Tensor         # [RP, PD]: window row <- dy patch row
    aut: torch.Tensor         # [T, RP]: dX row <- window row


def _bwd_axis(tile: int, up: int, down: int, pad0: int, nfu: int, nfd: int, rp: int,
              px: Optional[int] = None, pd: Optional[int] = None) -> BwdAxis:
    rows = (tile - 1) * up + nfu
    r0 = pad0 - (nfu - 1)
    x_min = -((pad0 - r0) // up)                           # ceil((r0 - pad0) / up)
    x_max = (r0 + rows - 1 - pad0 + nfu - 1) // up
    x_base = _even_floor(x_min)
    d_min = -((nfd - 1 - r0) // down)                      # ceil((r0 - nfd + 1) / down)
    d_max = (r0 + rows - 1) // down
    d_base = _even_floor(d_min)
    x_patch, d_patch = x_max - x_base + 1, d_max - d_base + 1
    px = px or _pad16(x_patch)
    pd = pd or _pad16(d_patch)
    au = _up_block(nfu, up, pad0, rows, rp, r0, x_base, px)
    # Ad^T: window row j reads dy row d_base + q through tap r0 + j - (d_base + q)*down.
    adt = _down_block(nfu, nfd, down, pd, r0, d_base, rp, rows).T.contiguous()
    # Au^T: dX row c reads window row j through tap c*up + pad0 - r0 - j.
    aut = _up_block(nfu, up, pad0, rows, rp, r0, 0, tile).T.contiguous()
    return BwdAxis(rows, r0, x_base, x_patch, d_base, d_patch, au, adt, aut)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """K2's tile plan: T x T dX tiles; per axis the blocks of Au, Ad^T and
    Au^T; RP window rows, PX x patch rows, PD dy patch rows, padded to 16."""
    tile: int
    dstep: int                # dy patch advance per tile: T*up/down
    rp: int
    px: int
    pd: int
    y: BwdAxis
    x: BwdAxis
    ops: dict                 # "au_y", "au_x", "adt_y", "adt_x", "aut_y", "aut_x"


@functools.lru_cache(maxsize=256)
def bwd_tile_plan(tile: int, up: int, down: int, padding: tuple, nfu: int,
                  nfd: int) -> BwdPlan:
    """K2's plan for T = `tile`; raises unless T*up is a multiple of down."""
    if (tile * up) % down or tile % MMA_K:
        raise ValueError(f"filtered_lrelu tile {tile}: T*up ({tile * up}) must be a "
                         f"multiple of down ({down}) and T of {MMA_K}")
    px0, _, py0, _ = padding
    rp = _pad16((tile - 1) * up + nfu)
    first = [_bwd_axis(tile, up, down, p, nfu, nfd, rp) for p in (py0, px0)]
    px = max(_pad16(a.x_patch) for a in first)
    pd = max(_pad16(a.d_patch) for a in first)
    ay = _bwd_axis(tile, up, down, py0, nfu, nfd, rp, px, pd)
    ax = _bwd_axis(tile, up, down, px0, nfu, nfd, rp, px, pd)
    ops = {f"{name}_{axis}": _axis_op(getattr(a, name))
           for name in ("au", "adt", "aut") for axis, a in (("y", ay), ("x", ax))}
    return BwdPlan(tile, tile * up // down, rp, px, pd, ay, ax, ops)


def pack_ops(ops: dict, names: tuple, widths: dict):
    """The operator blocks of `names` as the kernel copies them to shared
    memory: the tap indices of one buffer of [rows, ld] blocks (-1 for a zero;
    an axis's block shares the other's storage where the two are equal, and
    the buffer is whole 16-byte words of bf16), the int32 first K-block of
    each 16-row block's window (`kernel_windows` of `widths[name]` blocks),
    and {name: (offset, ld, first window entry, window width)}."""
    chunks, wins, where, seen, blocks = [], [], {}, {}, {}
    offset = 0
    for name in names:
        op, kb = ops[name], widths[name]
        key = (tuple(op.index.shape), op.index.numpy().tobytes())
        if key not in blocks:
            rows, k = op.index.shape
            stored = torch.full((rows, op.ld), -1, dtype=torch.int64)
            stored[:, :k] = op.index
            blocks[key] = offset
            chunks.append(stored.reshape(-1))
            offset += stored.numel()
        if (key, kb) not in seen:
            seen[key, kb] = len(wins)
            wins += [k0 for k0, _ in op.kernel_windows(kb)]
        where[name] = (blocks[key], op.ld, seen[key, kb], kb)
    index = torch.cat(chunks)
    index = torch.cat([index, index.new_full((-index.numel() % 8,), -1)])
    return index, torch.tensor(wins, dtype=torch.int32), where


def partial_products(a_parts: int, b_parts: int) -> int:
    """bf16 partial products the tensor-core kernels take for a product of
    operands held in `a_parts` and `b_parts` bf16 parts (one or three;
    csrc/filtered_lrelu_tc.cuh `mma_parts`): those above 2**-24 of the
    operands' scale."""
    return {1: 1, 3: 3, 9: 6}[a_parts * b_parts]


def fwd_executed_macs(plan: FwdPlan, widths: dict, tiles: int, parts: int = 1,
                      x_parts: Optional[int] = None) -> int:
    """Multiply-adds K1's tensor cores execute for `tiles` tiles: 16x16x16
    per K-block of each m16 x n16 item, `widths[op]` blocks per window, once
    per partial product of operators and stages held in `parts` bf16 parts
    and patches in `x_parts` (default `parts`)."""
    w = widths
    x_passes = partial_products(parts, parts if x_parts is None else x_parts)
    per = MMA_K * (x_passes * plan.rp * w["au_y"] * plan.pp       # t1 = Au . X
                   + partial_products(parts, parts)
                   * (plan.rp * w["au_x"] * plan.rp               # U = t1 . Bu^T
                      + plan.rp * w["ad_x"] * plan.tile           # t3 = Z . Bd^T
                      + plan.tile * w["ad_y"] * plan.tile))       # out = Ad . t3
    return per * tiles


def bwd_executed_macs(plan: BwdPlan, widths: dict, tiles: int) -> int:
    """The same for K2's six products."""
    w = widths
    per = MMA_K * (plan.rp * w["au_y"] * plan.px           # t1 = Au . X
                   + plan.rp * w["adt_y"] * plan.pd        # s1 = Ad^T . dY
                   + plan.rp * w["au_x"] * plan.rp         # U = t1 . Bu^T
                   + plan.rp * w["adt_x"] * plan.rp        # dZ = s1 . Bd
                   + plan.rp * w["aut_x"] * plan.tile      # dt1 = dU . Bu
                   + plan.tile * w["aut_y"] * plan.tile)   # dX = Au^T . dt1
    return per * tiles


def tile_counts(h: int, w: int, tile: int) -> tuple[int, int]:
    """(tiles down, tiles across) covering an h x w map."""
    return -(-h // tile), -(-w // tile)


# ---------------------------------------------------------------------------
# The tile plans contracted tile by tile, as the tensor-core kernels contract
# them: only the K-blocks of each window, at the kernels' fixed window widths;
# patches zero outside the map; ragged edge tiles cropped.


def tile_patches(x: torch.Tensor, starts_y: list, starts_x: list, size: int) -> torch.Tensor:
    """[tiles, planes, size, size] patches of x [planes, H, W] at each
    (start_y, start_x), tiles in row-major order, zero outside the map."""
    pad = size + max(abs(s) for s in (*starts_y, *starts_x))
    xp = torch.nn.functional.pad(x, (pad, pad, pad, pad))
    return torch.stack([xp[:, pad + sy:pad + sy + size, pad + sx:pad + sx + size]
                        for sy in starts_y for sx in starts_x])


def windowed_op(op: AxisOp, kb: int, taps: torch.Tensor, rounded) -> torch.Tensor:
    """The operator block, its entries `rounded`, with every entry outside
    its 16-row blocks' kernel windows (`kb` K-blocks each) dropped:
    contracting it is contracting only the windows, as the kernels do, and a
    window that missed a nonzero of the band drops it."""
    block = rounded(op.values(taps))
    keep = torch.zeros_like(block, dtype=torch.bool)
    for m, (k0, k1) in enumerate(op.kernel_windows(kb)):
        keep[MMA_K * m:MMA_K * (m + 1), MMA_K * k0:MMA_K * k1] = True
    return torch.where(keep, block, torch.zeros((), device=block.device))


def band_lhs(op: AxisOp, kb: int, b: torch.Tensor, taps: torch.Tensor, rounded,
             mm=torch.matmul) -> torch.Tensor:
    """op [M, K] . b [..., K, N], windows per 16-row block of op: an
    A-operand band (the kernels' t1, s1, out and dX products)."""
    return mm(windowed_op(op, kb, taps, rounded), b)


def band_rhs(a: torch.Tensor, op: AxisOp, kb: int, taps: torch.Tensor, rounded,
             mm=torch.matmul) -> torch.Tensor:
    """a [..., M, K] . op^T, op stored [N, K]: a B-operand band (U, t3, dZ,
    dt1), windows per 16 columns of the result."""
    return mm(a, windowed_op(op, kb, taps, rounded).T)


def untile(tiles: torch.Tensor, ty: int, tx: int, tile: int, h: int, w: int) -> torch.Tensor:
    """[ty*tx, planes, T, T] tiles -> [planes, h, w], the edge tiles cropped."""
    t = tiles.reshape(ty, tx, tiles.shape[1], tile, tile).permute(2, 0, 3, 1, 4)
    return t.reshape(tiles.shape[1], ty * tile, tx * tile)[:, :h, :w]


def _staged(x: torch.Tensor, plan, widths: dict, taps: torch.Tensor, mm):
    """The stage rounding to x's type, and the plan's band products by
    operator name: lhs(name, b) = op . b and rhs(a, name) = a . op^T."""
    rounded = lambda t: t.to(x.dtype).float()   # noqa: E731

    def lhs(name, b):
        return band_lhs(plan.ops[name], widths[name], b, taps, rounded, mm)

    def rhs(a, name):
        return band_rhs(a, plan.ops[name], widths[name], taps, rounded, mm)

    return rounded, lhs, rhs


def tiled_fwd_plain(x: torch.Tensor, plan: FwdPlan, widths: dict, taps: torch.Tensor,
                    gain: float, slope: float, clamp: Optional[float], out_hw: tuple,
                    mm=torch.matmul) -> torch.Tensor:
    """K1's and K3a's contraction of x [planes, H, W]: per T x T output
    tile, t1 = Au . X (patch), U = t1 . Bu^T, Z = act(U), t3 = Z . Bd^T,
    out = Ad . t3, stages rounded to x's type; every product is `mm`.
    `widths`: each operator's window in K-blocks, `taps`: the kernel's f32
    taps (`filtered_lrelu_cuda.kernel_geometry`)."""
    rounded, lhs, rhs = _staged(x, plan, widths, taps, mm)
    (oh, ow), tile = out_hw, plan.tile
    ty, tx = tile_counts(oh, ow, tile)
    xp = tile_patches(x.float(), [t * plan.step + plan.y.base for t in range(ty)],
                      [t * plan.step + plan.x.base for t in range(tx)], plan.pp)
    t1 = rounded(lhs("au_y", xp))
    z = rounded(act(rhs(t1, "au_x"), gain, slope, clamp))
    t3 = rounded(rhs(z, "ad_x"))
    return untile(lhs("ad_y", t3), ty, tx, tile, oh, ow).to(x.dtype)


def _bwd_patches(x: torch.Tensor, dy: Optional[torch.Tensor], plan: BwdPlan):
    """(tiles down, tiles across, x patches, dy patches or None)."""
    ty, tx = tile_counts(x.shape[1], x.shape[2], plan.tile)
    xp = tile_patches(x.float(), [t * plan.tile + plan.y.x_base for t in range(ty)],
                      [t * plan.tile + plan.x.x_base for t in range(tx)], plan.px)
    dp = None if dy is None else tile_patches(
        dy.float(), [t * plan.dstep + plan.y.d_base for t in range(ty)],
        [t * plan.dstep + plan.x.d_base for t in range(tx)], plan.pd)
    return ty, tx, xp, dp


def tiled_bwd_plain(x: torch.Tensor, dy: torch.Tensor, plan: BwdPlan, widths: dict,
                    taps: torch.Tensor, gain: float, slope: float, clamp: Optional[float],
                    u: Optional[torch.Tensor] = None, mm=torch.matmul, return_u: bool = False):
    """K2's and K3b's contraction of x [planes, H, W] along dy [planes, OH,
    OW]: per T x T dX tile, t1 = Au . X, s1 = Ad^T . dY, U = t1 . Bu^T,
    dU = (s1 . Bd) * act'(U), dt1 = dU . Bu, dX = Au^T . dt1, stages rounded
    to x's type, every product `mm`. `u` [tiles, planes, rp, rp] (tiles in
    row-major order, as `tile_patches`): act' taken from these values, a
    kernel's own U per tile, in place of this U; every other stage is
    computed here. Returns dX, or (dX, this U) with `return_u`."""
    rounded, lhs, rhs = _staged(x, plan, widths, taps, mm)
    (h, w), tile = x.shape[1:], plan.tile
    ty, tx, xp, dp = _bwd_patches(x, dy, plan)
    own_u = rhs(rounded(lhs("au_y", xp)), "au_x")
    g = act_grad(own_u if u is None else u, gain, slope, clamp)
    if not return_u:
        del own_u
    du = rounded(rhs(rounded(lhs("adt_y", dp)), "adt_x") * g)
    del g
    dt1 = rounded(rhs(du, "aut_x"))
    del du
    dx = untile(lhs("aut_y", dt1), ty, tx, tile, h, w).to(x.dtype)
    return (dx, own_u) if return_u else dx


def tiled_u_reach(x: torch.Tensor, plan: BwdPlan, widths: dict, taps: torch.Tensor,
                  near: float) -> torch.Tensor:
    """How far another summation order can move `tiled_bwd_plain`'s U,
    broadcastable against it [tiles, planes, rp, rp]. bf16 maps: `near` *
    max|t1| (per plane) * max|Bu|, the reach `act_flip_bound` assumes (one t1
    rounded the other way). f32 maps: (n + m + 8) * 2**-24 * (|Au| . |X| .
    |Bu|^T) per element, n and m the nonzeros of a row of the Au and Bu
    blocks: f32 sums of that many products, and three-part bf16 operands,
    stages and dropped partial products."""
    _, _, xp, _ = _bwd_patches(x, None, plan)
    if x.dtype == torch.bfloat16:
        rounded, lhs, _ = _staged(x, plan, widths, taps, torch.matmul)
        bu = windowed_op(plan.ops["au_x"], widths["au_x"], taps, rounded)
        return near * rounded(lhs("au_y", xp)).abs().amax((0, 2, 3), keepdim=True) * bu.abs().max()
    absolute = lambda t: t.abs()   # noqa: E731
    au, bu = plan.ops["au_y"], plan.ops["au_x"]
    scale = band_rhs(band_lhs(au, widths["au_y"], xp.abs(), taps, absolute), bu, widths["au_x"],
                     taps, absolute)
    rows = lambda op: int((op.index >= 0).sum(1).max())   # noqa: E731
    return (rows(au) + rows(bu) + 8) * 2.0 ** -24 * scale
