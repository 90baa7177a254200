"""The lres trainer's augmentations against the JAX package's, on the CPU:
DiffAugment per policy, `random_temporal_crop`, `temporal_scale_augment` and
`AugmentPipe.random_temporal_filter`. Each test draws from a JAX key as the
JAX function does (its split order), feeds those draws to the port, and holds
the outputs within 1e-6 max-abs. Then each port function on its own draws
from a `torch.Generator`."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.models import ada_augment as jax_ada
from long_video_gan_tpu.models import diff_augment as jax_diffaug
from long_video_gan_tpu.train import common as jax_common
from long_video_gan_tpu_torch.models import ada_augment, diff_augment
from long_video_gan_tpu_torch.train import common
from test_torch_lres_train import one_torch_thread  # noqa: F401

TOL = 1e-6
SHAPE = (4, 3, 8, 18, 32)


def _video(seed, shape=SHAPE):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _diffaug_draws(key, x_shape, policy):
    """The draws `jax_diffaug.diff_augment(key, x, policy)` makes, per op in
    the policy's order, as its key splits give them."""
    n, c, t, h, w = x_shape
    draws = []
    for p in policy.split(","):
        hh, ww = (t * h, w) if p == "color" else (h, w)
        for fn in jax_diffaug.AUGMENT_FNS[p]:
            key, sub = jax.random.split(key)
            if p == "color":
                draws.append(_t(jax.random.uniform(sub, (n, 1, 1, 1))).reshape(n))
            elif p == "translation":
                shift = round(max(hh, ww) * 0.25)
                kx, ky = jax.random.split(sub)
                draws.append([_t(jax.random.randint(k, (n,), -shift, shift + 1))
                              for k in (kx, ky)])
            else:
                cut_h, cut_w = int(hh * 0.5 + 0.5), int(ww * 0.5 + 0.5)
                kx, ky = jax.random.split(sub)
                draws.append([_t(jax.random.randint(kx, (n, 1, 1), 0, hh + (1 - cut_h % 2))),
                              _t(jax.random.randint(ky, (n, 1, 1), 0, ww + (1 - cut_w % 2)))])
    return draws


@pytest.mark.parametrize("policy", ["color", "translation", "cutout",
                                    "color,translation,cutout"])
@pytest.mark.parametrize("shape", [SHAPE, (3, 3, 5, 9, 16)])
def test_diff_augment_matches_jax(policy, shape):
    x = _video(1, shape)
    key = jax.random.key(2)
    want = np.asarray(jax_diffaug.diff_augment(key, jnp.asarray(x), policy))
    got = diff_augment.diff_augment(_t(x), policy, draws=_diffaug_draws(key, shape, policy))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert not np.allclose(want, x)


def test_diff_augment_color_after_geometry():
    """Color last, its contrast mean running over cut-out zeros: there the
    JAX package's float32 mean is itself up to ~4e-6 off the exact mean
    (torch's < 1e-7). So the port is held within 1e-6 of its own float64
    evaluation on the same draws, and the JAX output within 1e-5 of that."""
    policy = "translation,cutout,color"
    x = _video(1)
    key = jax.random.key(2)
    draws = _diffaug_draws(key, SHAPE, policy)
    want = np.asarray(jax_diffaug.diff_augment(key, jnp.asarray(x), policy))
    got = diff_augment.diff_augment(_t(x), policy, draws=draws).numpy()
    exact = diff_augment.diff_augment(_t(x).double(), policy, draws=draws).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=TOL)
    np.testing.assert_allclose(want, exact, rtol=0, atol=1e-5)


def test_diff_augment_gradient_matches_jax():
    """The input gradient (what R1 differentiates) through every op."""
    x, cot = _video(3), _video(4)
    key = jax.random.key(5)
    policy = "color,translation,cutout"
    _, pull = jax.vjp(lambda v: jax_diffaug.diff_augment(key, v, policy), jnp.asarray(x))
    (want,) = pull(jnp.asarray(cot))
    xt = _t(x).requires_grad_(True)
    y = diff_augment.diff_augment(xt, policy, draws=_diffaug_draws(key, SHAPE, policy))
    (got,) = torch.autograd.grad(y, xt, _t(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t", [8, 11])
def test_random_temporal_crop_matches_jax(t):
    x = _video(6, (5, 3, t, 4, 6))
    key = jax.random.key(7)
    want = np.asarray(jax_common.random_temporal_crop(key, jnp.asarray(x), 8))
    t0 = (_t(jax.random.randint(key, (5,), 0, t - 8 + 1)) if t > 8 else None)
    got = common.random_temporal_crop(_t(x), 8, t0=t0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [8, 9, 10])
@pytest.mark.parametrize("max_log2_scale", [1.0, 0.3])
def test_temporal_scale_augment_matches_jax(seed, max_log2_scale):
    x = _video(seed, (6, 3, 16, 4, 6))
    key = jax.random.key(seed)
    want = np.asarray(jax_common.temporal_scale_augment(key, jnp.asarray(x), max_log2_scale))
    k_sf, k_pad, k_crop = jax.random.split(key, 3)
    sf = jnp.exp2(jax.random.uniform(k_sf, (6,), minval=-max_log2_scale, maxval=max_log2_scale))
    got = common.temporal_scale_augment(
        _t(x), max_log2_scale, sf=_t(sf), u_pad=_t(jax.random.uniform(k_pad, (6,))),
        u_crop=_t(jax.random.uniform(k_crop, (6,))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # Some clips were stretched (zero-padded frames), some squeezed.
    assert (np.asarray(sf) > 1).any() and (np.asarray(sf) < 1).any()


def test_temporal_scale_augment_gradient_matches_jax():
    x, cot = _video(11, (6, 3, 16, 4, 6)), _video(12, (6, 3, 16, 4, 6))
    key = jax.random.key(13)
    _, pull = jax.vjp(lambda v: jax_common.temporal_scale_augment(key, v, 1.0), jnp.asarray(x))
    (want,) = pull(jnp.asarray(cot))
    k_sf, k_pad, k_crop = jax.random.split(key, 3)
    xt = _t(x).requires_grad_(True)
    y = common.temporal_scale_augment(
        xt, 1.0, sf=_t(jnp.exp2(jax.random.uniform(k_sf, (6,), minval=-1.0, maxval=1.0))),
        u_pad=_t(jax.random.uniform(k_pad, (6,))), u_crop=_t(jax.random.uniform(k_crop, (6,))))
    (got,) = torch.autograd.grad(y, xt, _t(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("t,max_ksize", [(12, 16), (8, 6)])
def test_random_temporal_filter_matches_jax(t, max_ksize):
    """Reflect padding past the clip's length (t 12, 16 taps) included; p
    0.5 leaves some clips unfiltered."""
    n = 8
    x = _video(14, (n, 3, t, 4, 6))
    key = jax.random.key(15)
    pipe_j = jax_ada.AugmentPipe()
    want = np.asarray(pipe_j.random_temporal_filter(key, jnp.asarray(x), 0.5,
                                                    max_ksize=max_ksize))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = (_t(jax.random.randint(k1, (n, 1, 1, 1, 1), 2, max_ksize + 1)).reshape(n),
             _t(jax.random.uniform(k2, (n, 1, 1, 1, 1))).reshape(n),
             _t(jax.random.normal(k3, (n, 1, max_ksize, 1, 1))).reshape(n, max_ksize),
             _t(jax.random.uniform(k4, (n, 1, 1, 1, 1))).reshape(n))
    got = ada_augment.AugmentPipe().random_temporal_filter(None, _t(x), 0.5,
                                                           max_ksize=max_ksize, draws=draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    filtered = (draws[3] > 0.5).numpy()
    assert filtered.any() and not filtered.all()
    np.testing.assert_array_equal(got.numpy()[~filtered], x[~filtered])


def test_augmentations_draw_from_a_generator():
    """Without injected draws each function draws from the generator: the
    same seed gives the same output, another seed another, the shapes stay."""
    x = _t(_video(16, (4, 3, 12, 9, 16)))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return (diff_augment.diff_augment(x, "color,translation,cutout", g),
                common.random_temporal_crop(x, 8, g),
                common.temporal_scale_augment(x, 1.0, g),
                ada_augment.AugmentPipe().random_temporal_filter(g, x, 0.0))

    a, b, c = run(0), run(0), run(1)
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v) and not torch.equal(u, w)
        assert bool(torch.isfinite(u).all())
    assert a[1].shape == (4, 3, 8, 9, 16)
    assert [tuple(u.shape) for i, u in enumerate(a) if i != 1] == [tuple(x.shape)] * 3
    with pytest.raises(ValueError, match="torch.Generator"):
        diff_augment.diff_augment(x, "color")
