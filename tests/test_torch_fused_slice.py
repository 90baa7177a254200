"""The `fused` slice as a whole, on the CPU: the reduced sres generator of
tests/test_torch_generators.py (up 4 at L2 and L3, up 2 elsewhere) with
`resample_impl="fused"` against the JAX package's, from the same weights (the
JAX fused kernel in Pallas interpret mode, f32, rtol 1e-3: the bar of
tests/test_parity_sres.py); and the tiny-preset sres trainer with G on
`fused`, whose G micro-loss gradient equals the `conv` path's (within 1e-4 of
each tensor's max |gradient|: f32 summation order) and which takes a step."""

import copy
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch.io.convert_torch import load_jax_variables
from long_video_gan_tpu_torch.models import generator_sres
from long_video_gan_tpu_torch.ops import filtered_lrelu_fused as fused
from long_video_gan_tpu_torch.train_sres import build_config, make_gan, train_step
from test_torch_generators import RTOL, SRES_KW, random_variables

jax_flr = importlib.import_module("long_video_gan_tpu.ops.filtered_lrelu")


@pytest.fixture
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jax_flr, "FORCE_FUSED_ON_CPU", True)


def test_fused_generator_matches_jax(interpret_pallas):
    kw = {**SRES_KW, "resample_impl": "fused"}
    G = jax_sres.VideoGenerator(**kw)
    variables = random_variables(G, jnp.zeros((1, 3, 8, 9, 16)), seed=60)
    port = generator_sres.VideoGenerator(**kw).eval()
    load_jax_variables(port, variables)
    assert [layer.up_factor for layer in port.SG3.synthesis.layers] == [2, 2, 4, 4, 2, 2, 1]
    rng = np.random.default_rng(61)
    lr = rng.standard_normal((1, 3, 8, 9, 16)).astype(np.float32)
    z = rng.standard_normal((1, 32)).astype(np.float32)
    want = np.asarray(G.apply(variables, jnp.asarray(lr), z=jnp.asarray(z)))
    fused.fwd_launches = 0
    with torch.no_grad():
        got = port(torch.from_numpy(lr), z=torch.from_numpy(z)).numpy()
    assert fused.fwd_launches == 0
    assert got.shape == want.shape == (1, 3, 4, 36, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def _tiny_config(impl):
    c = build_config("", 4, 2, 1.0, "tiny")
    c["gan_kwargs"]["G_kwargs"]["resample_impl"] = impl
    return c


def test_fused_trainer_gradient_matches_conv_and_steps():
    gans = {}
    for impl in ("fused", "conv"):
        gans[impl] = make_gan(_tiny_config(impl), torch.device("cpu"))
    gans["fused"].init_state(torch.Generator().manual_seed(62))
    gans["conv"].G.load_state_dict(gans["fused"].G.state_dict())
    gans["conv"].D.load_state_dict(gans["fused"].D.state_dict())
    rng = np.random.default_rng(63)
    lr = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 6, 8, 16)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    grads = {}
    for impl, gan in gans.items():
        gan.D.requires_grad_(False)
        loss, _ = gan.G_micro_loss(torch.Generator().manual_seed(64), lr, z=z)
        params = dict(gan.G.named_parameters())
        grads[impl] = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                           allow_unused=True)))
        gan.D.requires_grad_(True)
    for name, want in grads["conv"].items():
        got = grads["fused"][name]
        if want is None:
            assert got is None, name
            continue
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * max(want.abs().max(), 1e-6))

    gan, c = gans["fused"], _tiny_config("fused")
    ctx = c["seq_length"] + 2 * c["temporal_context"]
    gen = torch.Generator().manual_seed(65)

    def batches():
        while True:
            yield {"lr_video": torch.rand((4, 3, ctx, 8, 16), generator=gen) * 2 - 1,
                   "hr_video": torch.rand((4, 3, ctx, 32, 64), generator=gen) * 2 - 1}

    before = copy.deepcopy(gan.G.state_dict())
    stats = train_step(gan, torch.Generator().manual_seed(66), c, 0, batches())
    for s in stats:
        assert all(np.isfinite(float(v)) for v in s.values() if np.ndim(v) == 0), s
    assert any(not torch.equal(before[k], v) for k, v in gan.G.state_dict().items())
