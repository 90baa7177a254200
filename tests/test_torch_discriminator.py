"""The port's discriminator path against the JAX package's, on the CPU:
grid_sample / affine_grid (forward, gradients, second order), conv2d_resample,
the ADA AugmentPipe with `debug_percentile` (and at p = 0, where no draw
matters), and VideoDiscriminator (forward and input gradient, a non-square hr,
and the bf16 block ladder). The same numpy-seeded inputs and variables go
through both."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.models import ada_augment as jax_ada
from long_video_gan_tpu.models import discriminator_sres as jax_dsres
from long_video_gan_tpu.ops import filters as jax_filters
from long_video_gan_tpu_torch.io.convert_torch import load_jax_variables
from long_video_gan_tpu_torch.models import ada_augment, discriminator_sres
from long_video_gan_tpu_torch.ops.conv2d_resample import conv2d_resample
from long_video_gan_tpu_torch.ops.grid_sample import affine_grid, grid_sample
from test_torch_generators import random_variables

jax_grid = importlib.import_module("long_video_gan_tpu.ops.grid_sample")
jax_conv = importlib.import_module("long_video_gan_tpu.ops.conv2d_resample")


def _rel_err(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)))
                 / (float(np.max(np.abs(want))) or 1.0))


def _assert_match(got, want, tol):
    """The same non-finite entries (percentiles 0 and 1 make degenerate
    transforms in both frameworks), and the finite ones within `tol` of the
    largest finite |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if fin.any():
        assert _rel_err(got[fin], want[fin]) < tol


def _grid_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, 9, 11)).astype(np.float32)
    # Coordinates past the edges on purpose: zeros padding.
    grid = rng.uniform(-1.3, 1.3, (2, 7, 8, 2)).astype(np.float32)
    return x, grid


def test_grid_sample_and_grads_match_jax():
    x, grid = _grid_inputs(0)
    cot = np.random.default_rng(1).standard_normal((2, 3, 7, 8)).astype(np.float32)
    want, pull = jax.vjp(jax_grid.grid_sample, jnp.asarray(x), jnp.asarray(grid))
    want_dx, want_dg = pull(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    gt = torch.from_numpy(grid).requires_grad_(True)
    got = grid_sample(xt, gt)
    got_dx, got_dg = torch.autograd.grad(got, [xt, gt], torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dg.numpy(), np.asarray(want_dg), rtol=1e-4, atol=1e-4)
    # F.grid_sample is the same function.
    ref = torch.nn.functional.grid_sample(xt.detach(), gt.detach(), mode="bilinear",
                                          padding_mode="zeros", align_corners=False)
    torch.testing.assert_close(got.detach(), ref, rtol=1e-5, atol=1e-5)


def test_grid_sample_second_order_matches_jax():
    """d/dx |d/dx sum(w * sin(grid_sample(x, grid)))|^2, the shape of R1
    through the ADA warp."""
    x, grid = _grid_inputs(2)
    w = np.random.default_rng(3).standard_normal((2, 3, 7, 8)).astype(np.float32)

    def outer_jax(v):
        g = jax.grad(lambda u: jnp.sum(jnp.asarray(w) * jnp.sin(
            jax_grid.grid_sample(u, jnp.asarray(grid)))))(v)
        return jnp.sum(jnp.square(g))

    want = np.asarray(jax.grad(outer_jax)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = torch.sin(grid_sample(xt, torch.from_numpy(grid)))
    (g,) = torch.autograd.grad((torch.from_numpy(w) * out).sum(), xt, create_graph=True)
    (got,) = torch.autograd.grad(g.square().sum(), xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_affine_grid_matches_jax_and_torch():
    theta = np.random.default_rng(4).standard_normal((3, 2, 3)).astype(np.float32)
    size = (3, 1, 5, 7)
    want = np.asarray(jax_grid.affine_grid(jnp.asarray(theta), size))
    got = affine_grid(torch.from_numpy(theta), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ref = torch.nn.functional.affine_grid(torch.from_numpy(theta), list(size),
                                          align_corners=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


CONV_CASES = [
    # up, down, kernel, padding, flip_weight, groups
    (1, 1, 3, 1, True, 1),
    (1, 1, 3, (2, 0, -1, 1), False, 1),
    (1, 2, 3, 1, True, 1),
    (1, 2, 1, 0, True, 1),
    (2, 1, 3, 1, False, 1),
    (2, 2, 3, 1, False, 1),
    (1, 1, 3, 1, True, 2),
]


@pytest.mark.parametrize("up,down,k,padding,flip_weight,groups", CONV_CASES)
def test_conv2d_resample_matches_jax(up, down, k, padding, flip_weight, groups):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 10, 12)).astype(np.float32)
    w = rng.standard_normal((6, 4 // groups, k, k)).astype(np.float32)
    f = jax_filters.setup_filter([1, 3, 3, 1])
    kw = dict(f=f, up=up, down=down, padding=padding, groups=groups, flip_weight=flip_weight)
    y_shape = jax.eval_shape(lambda a, b: jax_conv.conv2d_resample(a, b, **kw),
                             jnp.asarray(x), jnp.asarray(w)).shape
    cot = rng.standard_normal(y_shape).astype(np.float32)
    want, pull = jax.vjp(lambda a, b: jax_conv.conv2d_resample(a, b, **kw),
                         jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = pull(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    got = conv2d_resample(xt, wt, **kw)
    got_dx, got_dw = torch.autograd.grad(got, [xt, wt], torch.from_numpy(cot))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(want_dw), rtol=1e-4, atol=1e-4)


# The trainer's ADA configuration (train_sres.py), the in_augment geometry
# without its noise (a random tensor whatever the percentile), and the
# image-space stages.
FULL_ADA = dict(xflip=1, rotate90=1, xint=1, scale=1, rotate=1, aniso=1, xfrac=1,
                brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1)
AUG_CONFIGS = {
    "ada": FULL_ADA,
    "in_augment": dict(scale=1, scale_std=0.08, rotate=1, rotate_max=0.016, aniso=1,
                       aniso_std=0.08, xfrac=1, xfrac_std=0.016, margin_frac=0.5),
    "filter_cutout": dict(imgfilter=1, cutout=1, brightness=1),
}


@pytest.mark.parametrize("dp", [0.0, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("name", sorted(AUG_CONFIGS))
def test_augment_pipe_debug_percentile_matches_jax(name, dp):
    cfg = AUG_CONFIGS[name]
    rng = np.random.default_rng(6)
    videos = rng.standard_normal((2, 3, 2, 12, 20)).astype(np.float32)
    cot = rng.standard_normal(videos.shape).astype(np.float32)
    pipe_j = jax_ada.AugmentPipe(**cfg)
    want, pull = jax.vjp(lambda v: pipe_j(jax.random.key(0), v, 0.7, debug_percentile=dp),
                         jnp.asarray(videos))
    (want_dv,) = pull(jnp.asarray(cot))
    pipe_t = ada_augment.AugmentPipe(**cfg)
    vt = torch.from_numpy(videos).requires_grad_(True)
    got = pipe_t(torch.Generator().manual_seed(0), vt, 0.7, debug_percentile=dp)
    (got_dv,) = torch.autograd.grad(got, vt, torch.from_numpy(cot))
    _assert_match(got.detach().numpy(), want, 1e-4)
    _assert_match(got_dv.numpy(), want_dv, 1e-4)


def test_augment_pipe_p0_matches_jax_and_draws_from_generator():
    """At p = 0 every stage draws its values but keeps the identity, so the
    two frameworks agree whatever they draw; at p = 1 the draws show."""
    rng = np.random.default_rng(7)
    videos = rng.standard_normal((3, 3, 2, 12, 20)).astype(np.float32)
    want = np.asarray(jax_ada.AugmentPipe(**FULL_ADA)(jax.random.key(1), jnp.asarray(videos),
                                                      0.0))
    pipe = ada_augment.AugmentPipe(**FULL_ADA)
    got = pipe(torch.Generator().manual_seed(1), torch.from_numpy(videos), 0.0)
    assert _rel_err(got.numpy(), want) < 1e-5
    a, b, c = (pipe(torch.Generator().manual_seed(s), torch.from_numpy(videos), 1.0)
               for s in (2, 2, 3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and bool(torch.isfinite(a).all())


# tests/test_train_steps.py SRES_CFG discriminator at 36x64, and a square one.
D_CFGS = {
    "nonsquare": dict(seq_length=2, lr_height=9, lr_width=16, hr_height=36, hr_width=64,
                      channels_base=512, channels_max=32),
    "square": dict(seq_length=2, lr_height=16, lr_width=16, hr_height=64, hr_width=64,
                   channels_base=1024, channels_max=64),
}


def _discriminator_pair(cfg, num_fp16_res, seed):
    D_j = jax_dsres.VideoDiscriminator(**cfg, num_fp16_res=num_fp16_res)
    lr0 = jnp.zeros((1, 3, cfg["seq_length"], cfg["lr_height"], cfg["lr_width"]))
    hr0 = jnp.zeros((1, 3, cfg["seq_length"], cfg["hr_height"], cfg["hr_width"]))
    variables = random_variables(D_j, lr0, hr0, seed=seed)
    D_t = discriminator_sres.VideoDiscriminator(**cfg, num_fp16_res=num_fp16_res)
    load_jax_variables(D_t, variables)
    return D_j, variables, D_t


@pytest.mark.parametrize("name", sorted(D_CFGS))
def test_video_discriminator_matches_jax(name):
    cfg = D_CFGS[name]
    D_j, variables, D_t = _discriminator_pair(cfg, 0, seed=8)
    rng = np.random.default_rng(9)
    lr = rng.standard_normal((2, 3, 2, cfg["lr_height"], cfg["lr_width"])).astype(np.float32)
    hr = rng.standard_normal((2, 3, 2, cfg["hr_height"], cfg["hr_width"])).astype(np.float32)
    cot = rng.standard_normal((2, 1)).astype(np.float32)
    want, pull = jax.vjp(lambda a, b: D_j.apply(variables, a, b), jnp.asarray(lr),
                         jnp.asarray(hr))
    want_dlr, want_dhr = pull(jnp.asarray(cot))
    lt = torch.from_numpy(lr).requires_grad_(True)
    ht = torch.from_numpy(hr).requires_grad_(True)
    got = D_t(lt, ht)
    got_dlr, got_dhr = torch.autograd.grad(got, [lt, ht], torch.from_numpy(cot))
    assert got.shape == (2, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    assert _rel_err(got_dlr.numpy(), want_dlr) < 1e-4
    assert _rel_err(got_dhr.numpy(), want_dhr) < 1e-4
    # The upsampled lr given directly is the same input.
    with torch.no_grad():
        torch.testing.assert_close(D_t(D_t.upsample_lr(lt), ht), got.detach(),
                                   rtol=1e-5, atol=1e-5)


def test_video_discriminator_bf16_ladder_matches_jax():
    """num_fp16_res > 0: the first blocks run in bfloat16 in both. With the
    JAX init's variables (biases 0), the outputs agree within 0.05 of max|out|
    and the input gradients within 0.1 in relative L2 norm: the two
    frameworks round at other places, and each framework's bf16 gradient is
    about 0.06 (relative L2) from its own f32 one here."""
    cfg = D_CFGS["nonsquare"]
    rng = np.random.default_rng(11)
    lr = rng.standard_normal((2, 3, 2, 9, 16)).astype(np.float32)
    hr = rng.standard_normal((2, 3, 2, 36, 64)).astype(np.float32)
    D_j = jax_dsres.VideoDiscriminator(**cfg, num_fp16_res=2)
    variables = D_j.init({"params": jax.random.key(3)}, jnp.asarray(lr), jnp.asarray(hr))
    D_t = discriminator_sres.VideoDiscriminator(**cfg, num_fp16_res=2)
    load_jax_variables(D_t, variables)
    assert [getattr(D_t, f"b{r}").use_fp16 for r in D_t.block_resolutions] == \
        [True, True, False, False]
    want, pull = jax.vjp(lambda b: D_j.apply(variables, jnp.asarray(lr), b), jnp.asarray(hr))
    (want_dhr,) = pull(jnp.ones((2, 1), jnp.float32))
    ht = torch.from_numpy(hr).requires_grad_(True)
    got = D_t(torch.from_numpy(lr), ht)
    (got_dhr,) = torch.autograd.grad(got.sum(), ht)
    assert got.dtype == torch.float32
    assert _rel_err(got.detach().numpy(), want) < 0.05
    want_dhr = np.asarray(want_dhr)
    assert np.linalg.norm(got_dhr.numpy() - want_dhr) / np.linalg.norm(want_dhr) < 0.1
    # R1's second order through the bf16 casts stays finite.
    ht = torch.from_numpy(hr).requires_grad_(True)
    (g,) = torch.autograd.grad(D_t(torch.from_numpy(lr), ht).sum(), ht, create_graph=True)
    g.square().sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in D_t.parameters()
               if p.grad is not None)
