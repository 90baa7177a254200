"""The tensor-core filtered_lrelu kernels, K1/K2 (`impl="packed"`) and K3a/K3b
(`impl="fused"`), on the CPU.

(a) Their plain versions (`filtered_lrelu_bands.banded_fwd_plain` /
    `banded_bwd_plain`: the four banded products with the TPU kernel's bf16
    stage rounding) against the JAX package's `_packed_fwd` / `_packed_bwd`,
    run in Pallas interpret mode, at the L3 (31x38, up 4, a crop) and L4
    (40x54, up 2) geometries of the 144x256 plan. Bars: f32 1e-5 forward and
    1e-4 gradient (summation order), bf16 2**-8 of the largest output (both
    round the same stages and differ only in f32 summation order before a
    rounding), as in tests/test_torch_fused.py.
(b) The host-built tile plans of the tensor-core kernels (operator blocks
    and band K-windows, `fwd_tile_plan` / `bwd_tile_plan`), contracted tile by
    tile as csrc/filtered_lrelu_tc.cu contracts them (`tiled_fwd_plain` /
    `tiled_bwd_plain`: only the K-blocks of each window, at the kernels'
    fixed window widths; patches zero outside the map, ragged edge tiles
    cropped),
    reproduce the plain versions at every L0-L14 geometry (L0-L2, the f32
    head layers, are K3's only; L14, the ToRGB identity, K4's and K5's):
    f32 to 1e-5, bf16 to 2**-8 of the largest output.
(c) The f32 kernels' three-part bf16 products (`filtered_lrelu_bands.
    split_matmul`), contracted over the same plans at L0-L2, meet K3a's and
    K3b's f32 bars, and with a bf16 patch in one part (K4/K5 on bf16 maps)
    at L4-L14 K4's and K5's bars; one bf16 pass and one TF32 pass do not.
(d) K3's, K4's and K5's tiles fit a block's shared memory at every plan
    geometry they serve.
(e) K2's and K3b's bars at their own act' decisions (selftest
    `_against_tiles`) with the contraction standing in for the kernel: sign
    flips of U near 0 pass, U beyond its reach and a dX with a wrong tap or
    slope fail, and the on-card fault (raw error past 0.03 of the scale
    through flips alone) passes.
(f) `tiled_bwd_plain` bit-equal to the contraction as this file held it
    before it moved into the package, at every L0-L14 geometry, and against
    the JAX package's `_packed_bwd` at L3 and L4.
"""

import importlib
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu_torch import selftest
from long_video_gan_tpu_torch.ops import filtered_lrelu_bands as bands
from long_video_gan_tpu_torch.ops import (filtered_lrelu_cuda, filtered_lrelu_exact,
                                          filtered_lrelu_fused)
from long_video_gan_tpu_torch.ops.filtered_lrelu import filtered_lrelu, output_size

jax_flr = importlib.import_module("long_video_gan_tpu.ops.filtered_lrelu")

BF16_BAR = 2.0 ** -8


@pytest.fixture(scope="module")
def plan_layers():
    return selftest.plan_layers()


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX packed kernel in interpret mode on the CPU, as the
    `jax_packed_interpret` fixture of tests/test_torch_ops.py runs it."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jax_flr, "FORCE_FUSED_ON_CPU", True)


def _layer_case(layer, planes, seed, scale=1.0):
    """Seeded numpy input of one plan layer's filtered_lrelu (bias added),
    its output gradient, its filters and keyword arguments."""
    rng = np.random.default_rng(seed)
    h, w = layer.in_size[1] + layer.kernel - 1, layer.in_size[0] + layer.kernel - 1
    fu, fd = (np.ones(1, np.float32) if f is None else f.numpy()
              for f in (layer.up_filter, layer.down_filter))
    gain, slope = (1.0, 1.0) if layer.is_torgb else (math.sqrt(2.0), 0.2)
    kw = dict(up=layer.up_factor, down=layer.down_factor, padding=tuple(layer.padding),
              gain=gain, slope=slope, clamp=layer.conv_clamp)
    x = (rng.standard_normal((1, planes, h, w)) * scale).astype(np.float32)
    oh, ow = output_size(h, w, fu, fd, kw["up"], kw["down"], kw["padding"])
    dy = rng.standard_normal((1, planes, oh, ow)).astype(np.float32)
    return x, dy, fu, fd, kw


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _assert_close(got, want, dtype, f32_tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    tol = f32_tol if dtype == torch.float32 else BF16_BAR * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=f32_tol, atol=tol)


# ---------------------------------------------------------------------------
# (a) The plain versions against the JAX packed kernels.


@pytest.mark.parametrize("idx", [3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_plain_matches_jax_packed(idx, dtype, plan_layers, interpret_pallas):
    x, _, fu, fd, kw = _layer_case(plan_layers[idx][1], 2, seed=idx)
    want = jax_flr.filtered_lrelu(_jax(x, dtype), fu, fd, None, impl="packed", **kw)
    filtered_lrelu_cuda.launches = 0
    got = filtered_lrelu(_torch(x, dtype), fu, fd, None, impl="packed", **kw)
    assert filtered_lrelu_cuda.launches == 0 and got.dtype == dtype
    _assert_close(got, want, dtype, 1e-5)


@pytest.mark.parametrize("idx", [3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_plain_matches_jax_packed(idx, dtype, plan_layers, interpret_pallas):
    """With a low clamp, so that a good share of the supersampled values
    saturate and act' is zero there."""
    x, dy, fu, fd, kw = _layer_case(plan_layers[idx][1], 1, seed=10 + idx, scale=3.0)
    kw["clamp"] = 4.0
    _, pull = jax.vjp(lambda v: jax_flr.filtered_lrelu(v, fu, fd, None, impl="packed", **kw),
                      _jax(x, dtype))
    (want,) = pull(_jax(dy, dtype))
    xt = _torch(x, dtype).requires_grad_(True)
    filtered_lrelu_cuda.bwd_launches = 0
    out = filtered_lrelu(xt, fu, fd, None, impl="packed", **kw)
    (got,) = torch.autograd.grad(out, xt, _torch(dy, dtype))
    assert filtered_lrelu_cuda.bwd_launches == 0 and got.dtype == dtype
    _assert_close(got, want, dtype, 1e-4)


# ---------------------------------------------------------------------------
# (b) The tile plans, contracted tile by tile as the kernels contract them.


def _close(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else BF16_BAR
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert got.shape == want.shape and err <= tol * scale, (err, scale)


def _contract(x, dy, fu, fd, kw, mm=torch.matmul, backward=True):
    """The forward's and (`backward`) the backward's tile plans of the
    wrapper contracted on one plane of x [1, 1, H, W] (and dy), every
    product `mm`."""
    up, down, pad = kw["up"], kw["down"], kw["padding"]
    taps = filtered_lrelu_cuda.kernel_geometry(x, fu, fd, up, down, pad)[3]
    geometry = (up, down, pad, len(fu), len(fd), torch.device("cpu"))
    act_kw = dict(taps=taps, gain=kw["gain"], slope=kw["slope"], clamp=kw["clamp"], mm=mm)

    def plan(backward):
        """The wrapper's plan and the window widths its kernel walks."""
        plan, _, _, where = filtered_lrelu_cuda._tc_plan(backward, *geometry)
        return plan, {name: w[3] for name, w in where.items()}

    out_hw = output_size(x.shape[2], x.shape[3], fu, fd, up, down, pad)
    return (bands.tiled_fwd_plain(x[0], *plan(False), out_hw=out_hw, **act_kw),
            bands.tiled_bwd_plain(x[0], dy[0], *plan(True), **act_kw) if backward else None)


@pytest.mark.parametrize("idx", range(15))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_plans_contract_to_plain(idx, dtype, plan_layers):
    """The forward's and the backward's tile plans at each layer of the
    plan: L0-L2 (f32, K3 only; a 29x36 plane takes two 32-wide tiles
    across), the bf16 layers that resample (L3 and L13 crop their padding;
    every layer has ragged edge tiles) and L14 (ToRGB, one-tap identity
    operators: K4/K5 only)."""
    x, dy, fu, fd, kw = _layer_case(plan_layers[idx][1], 1, seed=20 + idx, scale=2.0)
    x, dy = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    fwd, bwd = _contract(x, dy, fu, fd, kw)
    _close(fwd, bands.banded_fwd_plain(x, fu, fd, **kw)[0], dtype)
    _close(bwd, bands.banded_bwd_plain(x, dy, fu, fd, **kw)[0], dtype)


# ---------------------------------------------------------------------------
# (c) The f32 kernels' three-part products.


def _tf32(t):
    """t's operands rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF).view(torch.float32)


ONE_PASS = {
    "bf16": lambda a, b: a.bfloat16().float() @ b.bfloat16().float(),
    "tf32": lambda a, b: _tf32(a) @ _tf32(b),
}


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("idx", [0, 1, 2])
def test_split_products_meet_f32_bars(idx, backward, plan_layers):
    """At the f32 head layers, on one plane, the tile plans contracted with
    every product in three bf16 parts (six partial products, as the f32 K3a
    and K3b compute them) meet K3a's f32 bar (EXACT_F32_TOL against the f32
    plain version, forward) and K3b's bars at its own act' decisions
    (gradient: its U within f32 reach of the f32 contraction's, its dX within
    TOLS[f32] of the contraction's at that U); a single bf16 pass and a
    single TF32 pass do not (their U lies far outside the f32 reach)."""
    x, dy, fu, fd, kw = _layer_case(plan_layers[idx][1], 1, seed=40 + idx, scale=2.0)
    x, dy = torch.from_numpy(x), torch.from_numpy(dy)
    kernel = selftest.KERNELS["K3b" if backward else "K3a"]
    tol = kernel.tol(torch.float32)
    if backward:
        assert torch.float32 in kernel.tile_dtypes
    else:
        assert tol == selftest.EXACT_F32_TOL and not kernel.tile_dtypes

    def check(mm):
        if not backward:
            got = _contract(x, dy, fu, fd, kw, mm, backward=False)[0][None]
            return selftest._against_plain(
                "L", got, torch.float32, lambda s: bands.banded_fwd_plain(x[s], fu, fd, **kw),
                tol)
        return _tile_check(x, dy, fu, fd, kw, lambda *a, **k: _stand_in(*a, mm=mm, **k))

    c = check(bands.split_matmul)
    assert c.ok and c.rel_err <= (1e-4 if backward else tol), c
    if backward:
        assert c.u_reach_share <= 1.0 and c.tiles_rel_err <= 1e-4, c
    for name, mm in ONE_PASS.items():
        c = check(mm)
        assert not c.ok, (name, c)
        if backward:
            assert c.u_reach_share > 1.0, (name, c)


@pytest.mark.parametrize("idx", [4, 6, 8, 9, 11, 12, 14])
def test_exact_split_products_meet_bars(idx, plan_layers):
    """K4/K5 on bf16 maps, on one plane at each bf16 geometry they serve,
    L14's identity included: the forward tile plan contracted with the
    operators and the f32 stages in three bf16 parts and the bf16 patch
    exact in them (`split_matmul`: three partial products for t1 = Au . X,
    six for the others) meets EXACT_F32_TOL against the f32 plain version,
    and rounded once to bf16 meets their bf16 bar. A single bf16 pass and a
    single TF32 pass fail the f32 bar at every layer that resamples; at L14
    (identity operators, gain 1, slope 1) every pass is exact."""
    x, dy, fu, fd, kw = _layer_case(plan_layers[idx][1], 1, seed=80 + idx, scale=2.0)
    x = torch.from_numpy(x).bfloat16().float()   # bf16 maps; the stages are f32
    dy = torch.from_numpy(dy)
    kernel = selftest.KERNELS["K4"]
    plain = lambda s: kernel.plain(x[s], fu, fd, **kw)   # noqa: E731

    def check(mm):
        got = _contract(x, dy, fu, fd, kw, mm, backward=False)[0][None]
        return got, selftest._against_plain("L", got, torch.float32, plain,
                                            selftest.EXACT_F32_TOL)

    got, c = check(bands.split_matmul)
    assert c.ok and kernel.tol(torch.float32) == selftest.EXACT_F32_TOL, c
    c = selftest._against_plain("L", got.bfloat16(), torch.bfloat16, plain,
                                kernel.tol(torch.bfloat16), half_ulp=True)
    assert c.ok, c
    for name, mm in ONE_PASS.items():
        _, c = check(mm)
        assert c.ok == (idx == 14), (name, c)


# ---------------------------------------------------------------------------
# (d) The tensor-core kernels' shared-memory footprints.

SMEM_PER_BLOCK = 227 * 1024   # the H100's opt-in shared memory per block


def _align16(n):
    return -(-n // 16) * 16


def smem_bytes(backward, parts, plan, index, windows, x_parts=None):
    """A block's shared memory, as csrc/filtered_lrelu_tc.cuh `fwd_smem` /
    `bwd_smem` lay it out for `parts` bf16 parts per operator and stage and
    `x_parts` per patch (default `parts`): windows, operators, patch buffers
    (two for patches in one part; else three planes and a raw f32 patch),
    and `parts` planes of each stage."""
    ld = bands.smem_ld
    x_parts = parts if x_parts is None else x_parts
    head = _align16(windows.numel() * 4) + _align16(parts * index.numel() * 2)
    buffers = 2 if x_parts == 1 else x_parts

    def patch(n):
        return (buffers * _align16(n * ld(n) * 2)
                + (0 if x_parts == 1 else _align16(n * n * 4)))

    rp, tile = plan.rp, plan.tile
    last = _align16(max(rp * ld(rp), tile * ld(tile)) * 2)   # Z or dU, then the output tile
    if backward:
        stages = (_align16(max(rp * ld(plan.px), rp * ld(tile)) * 2)
                  + _align16(rp * ld(plan.pd) * 2) + last)
        return head + patch(plan.px) + patch(plan.pd) + parts * stages
    stages = _align16(max(rp * ld(plan.pp), rp * ld(tile)) * 2) + last
    return head + patch(plan.pp) + parts * stages


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_tiles_fit_shared_memory(dtype, backward, plan_layers):
    """At every L0-L13 geometry, K3's tile (`filtered_lrelu_fused.tile_for`)
    fits a block's shared memory in either map type; the f32 backward at up
    4 takes the half tile because the full one would not."""
    parts = filtered_lrelu_cuda.tc_parts(torch.empty(0, dtype=dtype))
    for name, layer in plan_layers[:14]:
        up = layer.up_factor
        geometry = (up, layer.down_factor, tuple(layer.padding), layer.up_filter.shape[0],
                    layer.down_filter.shape[0], torch.device("cpu"))
        tile = filtered_lrelu_fused.tile_for(backward, dtype, up)
        footprint = smem_bytes(backward, parts,
                               *filtered_lrelu_cuda._tc_plan(backward, *geometry, tile)[:3])
        assert footprint <= SMEM_PER_BLOCK, (name, tile, footprint)
        if tile != filtered_lrelu_cuda.TILE:
            full = smem_bytes(backward, parts, *filtered_lrelu_cuda._tc_plan(
                backward, *geometry, filtered_lrelu_cuda.TILE)[:3])
            assert full > SMEM_PER_BLOCK, (name, full)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_tiles_fit_shared_memory(dtype, plan_layers):
    """K4's and K5's 32-wide tile, operators and stages in three bf16 parts,
    the patch in one (bf16 maps) or three (f32), fits a block's shared memory
    at every plan geometry they serve and at up 4 (L3's filters with a top
    crop K4 takes, py0 = -3)."""
    x_parts = filtered_lrelu_cuda.tc_parts(torch.empty(0, dtype=dtype))
    cases = [(plan_layers[i][1], tuple(plan_layers[i][1].padding))
             for i in selftest.served_layers("K4", plan_layers)]
    cases.append((plan_layers[3][1], (-6, -9, -3, -9)))
    for layer, padding in cases:
        geometry = (layer.up_factor, layer.down_factor, padding,
                    len(bands.filter_taps(layer.up_filter)),
                    len(bands.filter_taps(layer.down_filter)), torch.device("cpu"))
        plan = filtered_lrelu_cuda._tc_plan(False, *geometry)[:3]
        footprint = smem_bytes(False, filtered_lrelu_exact.PARTS, *plan, x_parts=x_parts)
        assert footprint <= SMEM_PER_BLOCK, (layer.in_size, padding, footprint)


# ---------------------------------------------------------------------------
# (e) K2's and K3b's bars at their own act' decisions (selftest
#     `_against_tiles`), with the tile contraction standing in for the
#     kernel: (i) its U within reach of the contraction's, (ii) its dX against
#     the contraction's at that U, (iii) (on the card only) the check-only
#     launch bit-equal to the production one.


def _stand_in(x, dy, fu, fd, up, down, padding, gain, slope, clamp, mm=torch.matmul,
              flip=None, shift=None, taps_edit=None, slope_edit=None):
    """The tile contraction as a kernel's check-only launch: (dX, U per
    tile, the tile setup) on NCHW x along dy, every product `mm`. `flip(u, reach)` edits U
    (the act' decisions are taken there, and dX follows them); `shift(u,
    reach)` edits only the U it reports; `taps_edit` / `slope_edit` compute
    dX with a wrong tap or slope."""
    n, c, h, w = x.shape
    setup = filtered_lrelu_cuda.bwd_tile_setup(x, fu, fd, up, down, padding)
    plan, widths, taps = setup
    xp, dyp = x.reshape(n * c, h, w), dy.reshape(n * c, *dy.shape[2:])
    _, u = bands.tiled_bwd_plain(xp, dyp, plan, widths, taps, gain, slope, clamp, mm=mm,
                                 return_u=True)
    reach = bands.tiled_u_reach(xp, plan, widths, taps, selftest.FLIP_NEAR).expand_as(u)
    if flip is not None:
        u = flip(u, reach)
    dx = bands.tiled_bwd_plain(xp, dyp, plan, widths, taps if taps_edit is None else
                               taps_edit(taps), gain, slope if slope_edit is None else
                               slope_edit, clamp, u=u, mm=mm)
    if shift is not None:
        u = shift(u, reach)
    return dx.reshape(x.shape), u, setup


def _tile_check(x, dy, fu, fd, kw, launch_u):
    """selftest's K2/K3b check of `launch_u`'s dX as the production output:
    the raw error against the plain version as a reading, then (i)-(ii)."""
    out = launch_u(x, dy, fu, fd, **kw)[0]
    check = selftest._against_plain(
        "L", out, x.dtype, lambda s: bands.banded_bwd_plain(x[s], dy[s], fu, fd, **kw),
        selftest.TOLS[x.dtype], raw_bar=False)
    return selftest._against_tiles(check, out, x, dy, launch_u, fu, fd, **kw)


def _tile_case(layer, dtype, seed, planes=2):
    x, dy, fu, fd, kw = _layer_case(layer, planes, seed=seed, scale=2.0)
    return torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype), fu, fd, kw


def _flip_near_zero(count, within=0.5):
    """Flip the sign of U at the `count` elements (every one, for None)
    nearest 0 relative to their reach, among those within `within` of it."""
    def flip(u, reach):
        ratio = (u.abs() / reach.clamp_min(1e-38)).flatten()
        ratio = torch.where((u != 0).flatten() & (reach > 0).flatten(), ratio, math.inf)
        idx = torch.nonzero(ratio <= within).flatten()
        if count is not None:
            idx = idx[ratio[idx].argsort()[:count]]
        assert idx.numel() > 0
        out = u.clone().flatten()
        out[idx] = -out[idx]
        return out.reshape(u.shape)
    return flip


def _with_u_near_zero(x, layer_kw, fu, fd, dtype):
    """f32 x with one pixel per plane moved so that, in the first tile, the U
    at the largest |Au . X . Bu^T| of the middle window row and column is 0
    in f64: a U within f32 reach of 0, where another summation order can
    take either sign."""
    x = x.double().clone()
    n, c, h, w = x.shape
    plan, widths, taps = filtered_lrelu_cuda.bwd_tile_setup(x.float(), fu, fd, layer_kw["up"],
                                                           layer_kw["down"], layer_kw["padding"])
    same = lambda t: t   # noqa: E731
    au = bands.windowed_op(plan.ops["au_y"], widths["au_y"], taps, same).double()
    bu = bands.windowed_op(plan.ops["au_x"], widths["au_x"], taps, same).double()
    i = j = plan.y.rows // 2
    r, col = int(au[i].abs().argmax()), int(bu[j].abs().argmax())
    y0, x0 = plan.y.x_base + r, plan.x.x_base + col       # the first tile's patch origin
    for p in range(c):
        patch = torch.zeros(plan.px, plan.px, dtype=torch.float64)
        ys, xs = slice(max(plan.y.x_base, 0), plan.y.x_base + plan.px), slice(
            max(plan.x.x_base, 0), plan.x.x_base + plan.px)
        sub = x[0, p, ys, xs]
        patch[ys.start - plan.y.x_base:ys.start - plan.y.x_base + sub.shape[0],
              xs.start - plan.x.x_base:xs.start - plan.x.x_base + sub.shape[1]] = sub
        u = au[i] @ patch @ bu[j]
        x[0, p, y0, x0] -= float(u / (au[i, r] * bu[j, col]))
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("idx", [3, 4])
def test_tile_bars_pass_flips_near_zero(idx, dtype, plan_layers):
    """A kernel that took the other side of act' at a few U within half their
    reach of 0 (bf16: the three nearest; f32: the U set to 0 in f64 in each
    plane's first tile, flipped where f32 left it nonzero) passes (i) and
    (ii): its dX follows its own decisions. Its raw error is a reading."""
    name, layer = plan_layers[idx]
    x, dy, fu, fd, kw = _tile_case(layer, dtype, seed=70 + idx)
    count = 3
    if dtype == torch.float32:
        x = _with_u_near_zero(x, kw, fu, fd, dtype)
        count = None
    c = _tile_check(x, dy, fu, fd, kw, lambda *a, **k: _stand_in(
        *a, flip=_flip_near_zero(count), **k))
    assert c.ok and c.u_signs >= 1 and c.u_reach_share <= 1.0, c
    assert c.tiles_rel_err == 0.0 and c.dump_equal is None, c


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tile_bars_refuse_u_beyond_reach(dtype, plan_layers):
    """A U that lies one and a half reaches off at a single element, away
    from 0 (so no decision moves), fails (i) while its dX passes (ii)."""
    x, dy, fu, fd, kw = _tile_case(plan_layers[4][1], dtype, seed=74)

    def shift(u, reach):
        at = int((u.abs() / reach.clamp_min(1e-38)).flatten().argmax())
        out = u.clone().flatten()
        out[at] += 1.5 * reach.flatten()[at] * torch.sign(out[at])
        return out.reshape(u.shape)

    c = _tile_check(x, dy, fu, fd, kw, lambda *a, **k: _stand_in(*a, shift=shift, **k))
    assert not c.ok and 1.4 < c.u_reach_share < 1.6 and c.u_signs == 0, c
    assert c.tiles_rel_err == 0.0, c


def _wrong_tap(taps):
    out = taps.clone()
    out[int(taps.abs().argmax())] *= 1.01
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fault", ["tap", "slope"])
def test_tile_bars_refuse_wrong_dx(fault, dtype, plan_layers):
    """A dX computed with the largest tap 1% off, or with slope 0.25 for 0.2,
    at the kernel's own (right) U fails (ii): in f32 its max-abs bar, in
    bf16 the share of elements beyond one ulp of their own (a tap 1% off
    moves dX by less than K1_TOL of the scale, on a hundred times
    K1_ULP_SHARE of the elements)."""
    x, dy, fu, fd, kw = _tile_case(plan_layers[4][1], dtype, seed=76)
    edit = dict(taps_edit=_wrong_tap) if fault == "tap" else dict(slope_edit=0.25)
    c = _tile_check(x, dy, fu, fd, kw, lambda *a, **k: _stand_in(*a, **edit, **k))
    assert not c.ok and c.u_reach_share == 0.0, c
    if dtype == torch.float32:
        assert c.tiles_rel_err > c.tiles_tol, c
    else:
        assert c.tiles_ulp_share > 100 * selftest.K1_ULP_SHARE, c


@pytest.mark.parametrize("idx", [3, 4])
def test_tile_bars_pass_the_flip_fault(idx, plan_layers):
    """The on-card fault, reproduced: a bf16 input built with many U near 0
    (small maps with one large pixel per plane, which sets max|t1|), and a
    kernel that took the other side of act' at every U within half its
    reach. Its raw error passes 0.03 of the scale, past the raw TOLS[bf16]
    bar, and it passes (i) and (ii); its error beyond the flip bound stays
    within K2_RESIDUAL_TOL, every element past 2**-7 of the scale within a
    flip's reach (so many flips on so few elements exceed K2_OVER_SHARE,
    a bar made for the card's sizes)."""
    name, layer = plan_layers[idx]
    x, dy, fu, fd, kw = _tile_case(layer, torch.bfloat16, seed=78 + idx, planes=4)
    x = x.float() * 0.5
    x[0, :, x.shape[2] // 2, x.shape[3] // 2] = 10.0
    x = x.bfloat16()
    c = _tile_check(x, dy, fu, fd, kw, lambda *a, **k: _stand_in(
        *a, flip=_flip_near_zero(None), **k))
    assert c.rel_err > selftest.TOLS[torch.bfloat16], c
    assert c.ok and c.u_signs > 100 and c.u_reach_share <= 1.0, c
    out = _stand_in(x, dy, fu, fd, **kw, flip=_flip_near_zero(None))[0]
    beyond = selftest._against_plain(
        name, out, torch.bfloat16, lambda s: bands.banded_bwd_plain(x[s], dy[s], fu, fd, **kw),
        selftest.TOLS[torch.bfloat16], flip_bound=lambda s: bands.act_flip_bound(
            x[s], dy[s], fu, fd, **kw, near=selftest.FLIP_NEAR), raw_bar=False)
    assert beyond.beyond_flips_rel_err <= selftest.K2_RESIDUAL_TOL, beyond
    assert beyond.over_in_reach == beyond.over > 0, beyond


# ---------------------------------------------------------------------------
# (f) `tiled_bwd_plain`, the backward contraction moved into the package,
#     against the contraction as this file held it before (frozen below),
#     and against the JAX package's packed backward.



def _old_patches(x, starts_y, starts_x, size):
    """[tiles, planes, size, size] patches of x [planes, H, W] at each
    (start_y, start_x), zero outside the map."""
    planes, h, w = x.shape
    pad = size + max(abs(s) for s in (*starts_y, *starts_x))
    xp = torch.nn.functional.pad(x, (pad, pad, pad, pad))
    return torch.stack([xp[:, pad + sy:pad + sy + size, pad + sx:pad + sx + size]
                        for sy in starts_y for sx in starts_x])


def _old_windowed(op, kb, taps, rounded):
    """The operator block with every entry outside its 16-row blocks'
    kernel windows (`kb` K-blocks each) dropped: contracting it is
    contracting only the windows, as the kernels do, and a window that
    missed a nonzero of the band drops it."""
    block = rounded(op.values(taps))
    keep = torch.zeros_like(block, dtype=torch.bool)
    for m, (k0, k1) in enumerate(op.kernel_windows(kb)):
        keep[16 * m:16 * m + 16, 16 * k0:16 * k1] = True
    return torch.where(keep, block, torch.zeros(()))


def _old_lhs(op, kb, b, taps, rounded, mm=torch.matmul):
    """op [M, K] . b [..., K, N], windows per 16-row block of op: an
    A-operand band (the kernel's t1, s1, out and dX products)."""
    return mm(_old_windowed(op, kb, taps, rounded), b)


def _old_rhs(a, op, kb, taps, rounded, mm=torch.matmul):
    """a [..., M, K] . op^T, op stored [N, K]: a B-operand band (U, t3, dZ,
    dt1), windows per 16 columns of the result."""
    return mm(a, _old_windowed(op, kb, taps, rounded).T)


def _old_untile(tiles, ty, tx, tile, h, w):
    """[ty*tx, planes, T, T] tiles -> [planes, h, w], the edge tiles cropped."""
    t = tiles.reshape(ty, tx, tiles.shape[1], tile, tile).permute(2, 0, 3, 1, 4)
    return t.reshape(tiles.shape[1], ty * tile, tx * tile)[:, :h, :w]


def _old_tiled_bwd(x, dy, plan, widths, taps, gain, slope, clamp, mm=torch.matmul):
    """K2's contraction as it stood here: per T x T dX tile, t1 = Au . X, s1 = Ad^T . dY,
    dU = (s1 . Bd) * act'(t1 . Bu^T), dt1 = dU . Bu, dX = Au^T . dt1."""
    rounded = lambda t: t.to(x.dtype).float()   # noqa: E731
    (h, w), tile = x.shape[1:], plan.tile
    ty, tx = bands.tile_counts(h, w, tile)
    xp = _old_patches(x.float(), [t * tile + plan.y.x_base for t in range(ty)],
                  [t * tile + plan.x.x_base for t in range(tx)], plan.px)
    dp = _old_patches(dy.float(), [t * plan.dstep + plan.y.d_base for t in range(ty)],
                  [t * plan.dstep + plan.x.d_base for t in range(tx)], plan.pd)
    o = {name: (op, widths[name]) for name, op in plan.ops.items()}
    t1 = rounded(_old_lhs(*o["au_y"], xp, taps, rounded, mm))
    s1 = rounded(_old_lhs(*o["adt_y"], dp, taps, rounded, mm))
    g = bands.act_grad(_old_rhs(t1, *o["au_x"], taps, rounded, mm), gain, slope, clamp)
    du = rounded(_old_rhs(s1, *o["adt_x"], taps, rounded, mm) * g)
    dt1 = rounded(_old_rhs(du, *o["aut_x"], taps, rounded, mm))
    return _old_untile(_old_lhs(*o["aut_y"], dt1, taps, rounded, mm), ty, tx, tile, h,
                       w).to(x.dtype)


@pytest.mark.parametrize("idx", range(15))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_bwd_plain_is_the_contraction(idx, dtype, plan_layers):
    """At every L0-L14 geometry, `tiled_bwd_plain` with its own U (u=None)
    equals the contraction as it stood here bit for bit, and so does it at
    its own U passed back in as a kernel's (`u=`)."""
    x, dy, fu, fd, kw = _layer_case(plan_layers[idx][1], 2, seed=90 + idx, scale=2.0)
    x, dy = torch.from_numpy(x).to(dtype)[0], torch.from_numpy(dy).to(dtype)[0]
    plan, widths, taps = filtered_lrelu_cuda.bwd_tile_setup(x[None], fu, fd, kw["up"],
                                                           kw["down"], kw["padding"])
    act_kw = dict(gain=kw["gain"], slope=kw["slope"], clamp=kw["clamp"])
    got, u = bands.tiled_bwd_plain(x, dy, plan, widths, taps, **act_kw, return_u=True)
    want = _old_tiled_bwd(x, dy, plan, widths, taps, **act_kw)
    assert got.dtype == want.dtype == dtype and torch.equal(got, want)
    assert torch.equal(bands.tiled_bwd_plain(x, dy, plan, widths, taps, **act_kw, u=u), want)


@pytest.mark.parametrize("idx", [3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_bwd_plain_matches_jax_packed(idx, dtype, plan_layers, interpret_pallas):
    """`tiled_bwd_plain` against the JAX package's `_packed_bwd` (interpret
    mode) at L3 and L4, with a low clamp, at the bars of the K2 plain test
    above."""
    x, dy, fu, fd, kw = _layer_case(plan_layers[idx][1], 1, seed=110 + idx, scale=3.0)
    kw["clamp"] = 4.0
    _, pull = jax.vjp(lambda v: jax_flr.filtered_lrelu(v, fu, fd, None, impl="packed", **kw),
                      _jax(x, dtype))
    (want,) = pull(_jax(dy, dtype))
    xt, dyt = _torch(x, dtype), _torch(dy, dtype)
    plan, widths, taps = filtered_lrelu_cuda.bwd_tile_setup(xt, fu, fd, kw["up"], kw["down"],
                                                           kw["padding"])
    got = bands.tiled_bwd_plain(xt[0], dyt[0], plan, widths, taps, kw["gain"], kw["slope"],
                                kw["clamp"])
    assert got.dtype == dtype
    _assert_close(got[None], want, dtype, 1e-4)
