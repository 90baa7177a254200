"""The PyTorch port's op layer against the JAX package's, on the CPU: the same
numpy-seeded inputs through both (filters, bias_act, upfirdn2d and the plain
filtered_lrelu; the JAX packed kernel runs in Pallas interpret mode)."""

import importlib
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from long_video_gan_tpu.ops import filters as jax_filters
from long_video_gan_tpu_torch.ops import filters
from long_video_gan_tpu_torch.ops.bias_act import activation_funcs, bias_act
from long_video_gan_tpu_torch.ops.filtered_lrelu import filtered_lrelu
from long_video_gan_tpu_torch.ops.upfirdn2d import (
    downsample2d,
    filter2d,
    upfirdn2d,
    upsample2d,
)

# Via importlib: the JAX package's ops/__init__ re-exports functions under
# their modules' names.
jax_bias_act = importlib.import_module("long_video_gan_tpu.ops.bias_act")
jax_upfirdn2d = importlib.import_module("long_video_gan_tpu.ops.upfirdn2d")

FILTER_CASES = [
    ("design_kaiser_lowpass", (12, 1.0, 2.0, 8.0), {}),
    ("design_kaiser_lowpass", (24, 2.83, 10.3, 64.0), {}),
    ("design_lowpass_filter", (12, 16.0, 12.0, 64.0), {}),
    ("design_lowpass_filter", (12, 16.0, 12.0, 64.0), {"radial": True}),
    ("design_lowpass_filter", (1, 16.0, 12.0, 64.0), {}),
    ("tent_filter", (2,), {}),
    ("tent_filter", (4,), {}),
    ("binomial_filter", (), {}),
    ("kaiser_resample_filter", (2,), {}),
    ("kaiser_resample_filter", (8,), {"filter_size": 4}),
    ("setup_filter", ([1, 3, 3, 1],), {}),
    ("setup_filter", (np.arange(1, 9),), {"flip_filter": True, "gain": 4.0}),
    ("wavelet_lowpass", ("sym6",), {}),
]


@pytest.mark.parametrize("name,args,kwargs", FILTER_CASES)
def test_filters_bitwise(name, args, kwargs):
    want = getattr(jax_filters, name)(*args, **kwargs)
    got = getattr(filters, name)(*args, **kwargs)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("act", sorted(activation_funcs))
def test_bias_act_matches_jax(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4, 6)).astype(np.float32) * 3
    b = rng.standard_normal(5).astype(np.float32)
    for kw in (dict(), dict(gain=0.7, clamp=1.5), dict(alpha=0.3, clamp=0.0)):
        want = np.asarray(jax_bias_act.bias_act(jnp.asarray(x), jnp.asarray(b), act=act, **kw))
        got = bias_act(torch.from_numpy(x), torch.from_numpy(b), act=act, **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _taps(n):
    return jax_filters.design_kaiser_lowpass(n, 1.0, 2.0, 8.0)


UPFIRDN_CASES = [
    # up, down, padding, filter, flip_filter
    (1, 1, 0, _taps(8), False),
    (2, 1, (3, 4, 2, 5), _taps(8), False),
    (4, 1, 6, _taps(12), True),
    (1, 2, 3, _taps(8), False),
    (1, 4, (5, 6, 7, 8), _taps(12), False),
    (2, 2, (9, 8, 9, 8), _taps(12), False),
    (4, 2, (-6, -9, -6, -9), _taps(24), False),
    (2, 2, (-3, -4, 1, -2), _taps(12), True),
    ((1, 2), (2, 1), (0, -2, 4, 2), _taps(8), False),
    (2, 1, 2, np.outer(_taps(6), _taps(6)), False),                 # 2-D filter
    (1, 2, (1, 2, 3, 4), np.arange(12, dtype=np.float32).reshape(3, 4) / 66, True),
    (2, 1, (1, 1), None, False),                                    # identity filter
    ((1, 2), 1, (0, 0, 2, 1), _taps(4).reshape(-1, 1), False),      # [taps, 1] (temporal)
]


@pytest.mark.parametrize("up,down,padding,f,flip", UPFIRDN_CASES)
def test_upfirdn2d_matches_jax(up, down, padding, f, flip):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 11, 13)).astype(np.float32)
    kw = dict(up=up, down=down, padding=padding, flip_filter=flip, gain=1.7)
    want = np.asarray(jax_upfirdn2d.upfirdn2d(jnp.asarray(x), f, impl="conv", **kw))
    got = upfirdn2d(torch.from_numpy(x), f, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # A filter given as a tensor (a module buffer) is the same filter.
    if f is not None:
        got_t = upfirdn2d(torch.from_numpy(x), torch.as_tensor(np.asarray(f, np.float32)),
                          **kw).numpy()
        np.testing.assert_array_equal(got_t, got)


@pytest.mark.parametrize("fn", ["upsample2d", "downsample2d", "filter2d"])
def test_resample_wrappers_match_jax(fn):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 2, 10, 14)).astype(np.float32)
    f = jax_filters.kaiser_resample_filter(2)
    kw = dict(padding=(1, 2, 0, -1))
    if fn != "filter2d":
        kw[{"upsample2d": "up", "downsample2d": "down"}[fn]] = 2
    want = np.asarray(getattr(jax_upfirdn2d, fn)(jnp.asarray(x), f, **kw))
    got = {"upsample2d": upsample2d, "downsample2d": downsample2d,
           "filter2d": filter2d}[fn](torch.from_numpy(x), f, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture
def jax_packed_interpret(monkeypatch):
    """Run the JAX package's packed Pallas kernel in interpret mode on the CPU,
    as tests/test_pallas_packed.py does."""
    from jax.experimental import pallas as pl

    flr_mod = importlib.import_module("long_video_gan_tpu.ops.filtered_lrelu")
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(flr_mod, "FORCE_FUSED_ON_CPU", True)
    return flr_mod.filtered_lrelu


# Small versions of every filtered_lrelu geometry of the 144x256 sres plan:
# up2 (9,8,9,8) 12 taps (L0-L2, L4, L6, L8, L9, L11, L12), up4 (-6,-9,-6,-9)
# 24 taps (L3, L5, L7, L10) and up2 (-11,-12,-11,-12) 12 taps (L13).
FLRELU_CASES = [
    (2, 10, 16, (9, 8, 9, 8), 12),
    (4, 14, 18, (-6, -9, -6, -9), 24),
    (2, 30, 36, (-11, -12, -11, -12), 12),
]


@pytest.mark.parametrize("up,h,w,pad,fu_taps", FLRELU_CASES)
def test_filtered_lrelu_plain_matches_jax(up, h, w, pad, fu_taps, jax_packed_interpret):
    rng = np.random.default_rng(4)
    fu = jax_filters.design_kaiser_lowpass(fu_taps, 1.0, 2.0 * up, 8.0 * up)
    fd = _taps(12)
    x = rng.standard_normal((2, 3, h, w)).astype(np.float32) * 3
    b = rng.standard_normal(3).astype(np.float32)
    kw = dict(up=up, down=2, padding=pad, gain=math.sqrt(2.0), slope=0.2, clamp=4.0)
    want_conv = np.asarray(jax_packed_interpret(jnp.asarray(x), fu, fd, jnp.asarray(b),
                                                impl="conv", **kw))
    want_packed = np.asarray(jax_packed_interpret(jnp.asarray(x), fu, fd, jnp.asarray(b),
                                                  impl="packed", **kw))
    for impl in ("conv", "packed"):     # "packed" on a CPU tensor is the plain version
        got = filtered_lrelu(torch.from_numpy(x), fu, fd, torch.from_numpy(b), impl=impl,
                             **kw).numpy()
        assert got.shape == want_conv.shape
        np.testing.assert_allclose(got, want_conv, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want_packed, rtol=1e-5, atol=1e-5)


def test_filtered_lrelu_bf16_close_to_jax_packed(jax_packed_interpret):
    """The bar of tests/test_pallas_packed.py: bf16 within 0.05 max|ref| of
    the f32 reference."""
    rng = np.random.default_rng(5)
    fu = fd = _taps(12)
    x32 = rng.standard_normal((2, 4, 20, 28)).astype(np.float32)
    b32 = rng.standard_normal(4).astype(np.float32)
    kw = dict(up=2, down=2, padding=9, clamp=256.0)
    want = np.asarray(jax_packed_interpret(jnp.asarray(x32), fu, fd, jnp.asarray(b32), **kw))
    jax_bf16 = jax_packed_interpret(jnp.asarray(x32, jnp.bfloat16), fu, fd,
                                    jnp.asarray(b32, jnp.bfloat16), impl="packed", **kw)
    got = filtered_lrelu(torch.from_numpy(x32).bfloat16(), fu, fd,
                         torch.from_numpy(b32).bfloat16(), impl="packed", **kw)
    assert got.dtype == torch.bfloat16
    scale = float(np.max(np.abs(want)))
    for out in (got.float().numpy(), np.asarray(jax_bf16, np.float32)):
        assert np.max(np.abs(out - want)) <= 0.05 * scale
    assert np.max(np.abs(got.float().numpy() - np.asarray(jax_bf16, np.float32))) <= 0.05 * scale
