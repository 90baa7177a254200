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
    tile here as csrc/filtered_lrelu_tc.cu contracts them (only the K-blocks
    of each window, at the kernels' fixed window widths; patches zero outside
    the map, ragged edge tiles cropped),
    reproduce the plain versions at every L0-L14 geometry (L0-L2, the f32
    head layers, are K3's only; L14, the ToRGB identity, K4's and K5's):
    f32 to 1e-5, bf16 to 2**-8 of the largest output.
(c) The f32 kernels' three-part bf16 products (`filtered_lrelu_bands.
    split_matmul`), contracted over the same plans at L0-L2, meet K3a's and
    K3b's f32 bars, and with a bf16 patch in one part (K4/K5 on bf16 maps)
    at L4-L14 K4's and K5's bars; one bf16 pass and one TF32 pass do not.
(d) K3's, K4's and K5's tiles fit a block's shared memory at every plan
    geometry they serve.
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


def _patches(x, starts_y, starts_x, size):
    """[tiles, planes, size, size] patches of x [planes, H, W] at each
    (start_y, start_x), zero outside the map."""
    planes, h, w = x.shape
    pad = size + max(abs(s) for s in (*starts_y, *starts_x))
    xp = torch.nn.functional.pad(x, (pad, pad, pad, pad))
    return torch.stack([xp[:, pad + sy:pad + sy + size, pad + sx:pad + sx + size]
                        for sy in starts_y for sx in starts_x])


def _windowed(op, kb, taps, rounded):
    """The operator block with every entry outside its 16-row blocks'
    kernel windows (`kb` K-blocks each) dropped: contracting it is
    contracting only the windows, as the kernels do, and a window that
    missed a nonzero of the band drops it."""
    block = rounded(op.values(taps))
    keep = torch.zeros_like(block, dtype=torch.bool)
    for m, (k0, k1) in enumerate(op.kernel_windows(kb)):
        keep[16 * m:16 * m + 16, 16 * k0:16 * k1] = True
    return torch.where(keep, block, torch.zeros(()))


def _lhs(op, kb, b, taps, rounded, mm=torch.matmul):
    """op [M, K] . b [..., K, N], windows per 16-row block of op: an
    A-operand band (the kernel's t1, s1, out and dX products)."""
    return mm(_windowed(op, kb, taps, rounded), b)


def _rhs(a, op, kb, taps, rounded, mm=torch.matmul):
    """a [..., M, K] . op^T, op stored [N, K]: a B-operand band (U, t3, dZ,
    dt1), windows per 16 columns of the result."""
    return mm(a, _windowed(op, kb, taps, rounded).T)


def _untile(tiles, ty, tx, tile, h, w):
    """[ty*tx, planes, T, T] tiles -> [planes, h, w], the edge tiles cropped."""
    t = tiles.reshape(ty, tx, tiles.shape[1], tile, tile).permute(2, 0, 3, 1, 4)
    return t.reshape(tiles.shape[1], ty * tile, tx * tile)[:, :h, :w]


def tiled_fwd(x, plan, widths, taps, gain, slope, clamp, out_hw, mm=torch.matmul):
    """K1's contraction: per T x T output tile, t1 = Au . X (patch), U = t1 .
    Bu^T, Z = act(U), t3 = Z . Bd^T, out = Ad . t3, stages rounded to x's
    type; every product is `mm`."""
    rounded = lambda t: t.to(x.dtype).float()   # noqa: E731
    (oh, ow), tile = out_hw, plan.tile
    ty, tx = bands.tile_counts(oh, ow, tile)
    xp = _patches(x.float(), [t * plan.step + plan.y.base for t in range(ty)],
                  [t * plan.step + plan.x.base for t in range(tx)], plan.pp)
    o = {name: (op, widths[name]) for name, op in plan.ops.items()}
    t1 = rounded(_lhs(*o["au_y"], xp, taps, rounded, mm))
    z = rounded(bands.act(_rhs(t1, *o["au_x"], taps, rounded, mm), gain, slope, clamp))
    t3 = rounded(_rhs(z, *o["ad_x"], taps, rounded, mm))
    return _untile(_lhs(*o["ad_y"], t3, taps, rounded, mm), ty, tx, tile, oh, ow).to(x.dtype)


def tiled_bwd(x, dy, plan, widths, taps, gain, slope, clamp, mm=torch.matmul):
    """K2's contraction: per T x T dX tile, t1 = Au . X, s1 = Ad^T . dY,
    dU = (s1 . Bd) * act'(t1 . Bu^T), dt1 = dU . Bu, dX = Au^T . dt1."""
    rounded = lambda t: t.to(x.dtype).float()   # noqa: E731
    (h, w), tile = x.shape[1:], plan.tile
    ty, tx = bands.tile_counts(h, w, tile)
    xp = _patches(x.float(), [t * tile + plan.y.x_base for t in range(ty)],
                  [t * tile + plan.x.x_base for t in range(tx)], plan.px)
    dp = _patches(dy.float(), [t * plan.dstep + plan.y.d_base for t in range(ty)],
                  [t * plan.dstep + plan.x.d_base for t in range(tx)], plan.pd)
    o = {name: (op, widths[name]) for name, op in plan.ops.items()}
    t1 = rounded(_lhs(*o["au_y"], xp, taps, rounded, mm))
    s1 = rounded(_lhs(*o["adt_y"], dp, taps, rounded, mm))
    g = bands.act_grad(_rhs(t1, *o["au_x"], taps, rounded, mm), gain, slope, clamp)
    du = rounded(_rhs(s1, *o["adt_x"], taps, rounded, mm) * g)
    dt1 = rounded(_rhs(du, *o["aut_x"], taps, rounded, mm))
    return _untile(_lhs(*o["aut_y"], dt1, taps, rounded, mm), ty, tx, tile, h, w).to(x.dtype)


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
    return (tiled_fwd(x[0], *plan(False), out_hw=out_hw, **act_kw),
            tiled_bwd(x[0], dy[0], *plan(True), **act_kw) if backward else None)


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
    and K3b compute them) meet K3a's f32 bar (EXACT_F32_TOL, forward) and
    K3b's (1e-4 beyond witnessed act' flips, gradient) against the f32 plain
    versions; a single bf16 pass and a single TF32 pass do not."""
    x, dy, fu, fd, kw = _layer_case(plan_layers[idx][1], 1, seed=40 + idx, scale=2.0)
    x, dy = torch.from_numpy(x), torch.from_numpy(dy)
    kernel = selftest.KERNELS["K3b" if backward else "K3a"]
    tol = kernel.tol(torch.float32)
    if backward:
        assert tol == 1e-4 and kernel.f32_flip_witness
        bars = dict(witness=lambda s, err: bands.act_flip_witness(x[s], dy[s], err, fu, fd,
                                                                  **kw))
        plain = lambda s: bands.banded_bwd_plain(x[s], dy[s], fu, fd, **kw)   # noqa: E731
    else:
        assert tol == selftest.EXACT_F32_TOL and not kernel.f32_flip_witness
        bars = {}
        plain = lambda s: bands.banded_fwd_plain(x[s], fu, fd, **kw)   # noqa: E731

    def check(mm):
        got = _contract(x, dy, fu, fd, kw, mm)[int(backward)]
        return selftest._against_plain("L", got[None], torch.float32, plain, tol, **bars)

    c = check(bands.split_matmul)
    assert c.ok and c.rel_err <= (1e-4 if backward else tol), c
    for name, mm in ONE_PASS.items():
        c = check(mm)
        assert not c.ok, (name, c)
        if backward:
            assert c.beyond_flips_rel_err > 1e-4, (name, c)


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
