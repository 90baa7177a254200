"""The port's generators against the JAX package's, on the CPU: the layer
plan, the state_dict layout at full width (from `jax.eval_shape`, no
forward), and tiny-config forwards from the same variables with injected
noise and z."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.io.convert_torch import flax_path_to_torch_key
from long_video_gan_tpu.models import generator_lres as jax_lres
from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch.io.convert_torch import load_jax_variables
from long_video_gan_tpu_torch.models import generator_lres, generator_sres

# Sizes of tests/test_generators.py.
LRES_KW = dict(out_height=18, out_width=32, temporal_emb_dim=64, latent_w_dim=64,
               temporal_padding=2, channel_max=32,
               embedding_kwargs=dict(min_sampling_rate=10, max_sampling_rate=40, blur_widths=16))
SRES_KW = dict(hr_height=36, hr_width=64, lr_height=9, lr_width=16, temporal_context=2,
               latent_z_dim=32, latent_w_dim=32, margin_size=4, num_fp16_res=0,
               channel_base=1024, channel_max=32, num_layers=6)
# The bar of tests/test_parity_sres.py.
RTOL, ATOL = 1e-3, 2e-3


def random_variables(G, *init_args, seed=0):
    """Variables of G's init shapes (`jax.eval_shape`, no init trace) filled
    from a seeded numpy generator: N(0, 1) everywhere, magnitude EMAs in
    [0.9, 1.1], so no bias, EMA or w_avg sits at a trivial value."""
    shapes = jax.eval_shape(lambda: G.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, *init_args))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if "magnitude_ema" in jax.tree_util.keystr(path):
            return rng.uniform(0.9, 1.1, s.shape).astype(s.dtype)
        return rng.standard_normal(s.shape).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _flat_shapes(tree):
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(k.key for k in keypath)
        out[flax_path_to_torch_key(path[1:])] = tuple(leaf.shape)
    return out


def test_synthesis_layer_plan_matches_jax():
    want = jax_sres.synthesis_layer_plan(256, 144, 3)
    got = generator_sres.synthesis_layer_plan(256, 144, 3)
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_full_width_sres_state_dict_layout():
    kw = dict(hr_height=144, hr_width=256, lr_height=36, lr_width=64, temporal_context=4,
              num_fp16_res=4, resample_impl="auto")
    G = jax_sres.VideoGenerator(**kw)
    shapes = jax.eval_shape(lambda: G.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)},
        jnp.zeros((1, 3, 9, 36, 64))))
    port = generator_sres.VideoGenerator(**kw, device="meta")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == _flat_shapes(shapes)
    n_params = sum(p.numel() for p in port.SG3.synthesis.parameters())
    assert n_params == 26_644_628
    # The bf16 layers L3-L13 resample through the kernel policy.
    impls = [(layer.use_fp16, layer.up_factor) for layer in port.SG3.synthesis.layers]
    assert [i for i, (fp16, up) in enumerate(impls) if fp16 and up > 1] == list(range(3, 14))


def test_full_width_lres_state_dict_layout():
    G = jax_lres.VideoGenerator()
    shapes = jax.eval_shape(lambda: G.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, 1, 8))
    port = generator_lres.VideoGenerator(device="meta")
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == _flat_shapes(shapes)


@pytest.fixture(scope="module")
def sres_pair():
    G = jax_sres.VideoGenerator(**SRES_KW)
    variables = random_variables(G, jnp.zeros((1, 3, 8, 9, 16)), seed=0)
    port = generator_sres.VideoGenerator(**SRES_KW)
    load_jax_variables(port, variables)
    return G, variables, port.eval()


@pytest.fixture(scope="module")
def lres_pair():
    G = jax_lres.VideoGenerator(**LRES_KW)
    variables = random_variables(G, 1, 8, seed=1)
    port = generator_lres.VideoGenerator(**LRES_KW)
    load_jax_variables(port, variables)
    return G, variables, port.eval()


@pytest.mark.parametrize("psi", [1.0, 0.5])
def test_sres_forward_matches_jax(sres_pair, psi):
    G, variables, port = sres_pair
    rng = np.random.default_rng(2)
    lr = rng.standard_normal((2, 3, 8, 9, 16)).astype(np.float32)
    z = rng.standard_normal((2, 32)).astype(np.float32)
    want = np.asarray(G.apply(variables, jnp.asarray(lr), z=jnp.asarray(z), truncation_psi=psi))
    with torch.no_grad():
        got = port(torch.from_numpy(lr), z=torch.from_numpy(z), truncation_psi=psi).numpy()
    assert got.shape == want.shape == (2, 3, 4, 36, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_sres_truncation_cutoff_matches_jax(sres_pair):
    G, variables, port = sres_pair
    rng = np.random.default_rng(3)
    z = rng.standard_normal((1, 32)).astype(np.float32)
    want = np.asarray(G.apply(variables, jnp.asarray(z), truncation_psi=0.0,
                              truncation_cutoff=3, method=lambda m, z, **kw: m.SG3.mapping(z, **kw)))
    with torch.no_grad():
        got = port.SG3.mapping(torch.from_numpy(z), truncation_psi=0.0,
                               truncation_cutoff=3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # psi = 0 collapses the first `cutoff` ws onto w_avg.
    np.testing.assert_allclose(got[0, :3], np.broadcast_to(port.SG3.mapping.w_avg.numpy(),
                                                           (3, 32)), rtol=1e-6, atol=1e-6)


def test_sres_bf16_forward_close_to_jax():
    """num_fp16_res=2 puts the high-res layers in bf16; resample_impl="auto"
    sends them through the kernel policy (the plain version on the CPU)."""
    kw = {**SRES_KW, "num_fp16_res": 2, "resample_impl": "auto"}
    G = jax_sres.VideoGenerator(**kw)
    variables = random_variables(G, jnp.zeros((1, 3, 8, 9, 16)), seed=4)
    port = generator_sres.VideoGenerator(**kw)
    load_jax_variables(port, variables)
    assert any(layer.use_fp16 for layer in port.SG3.synthesis.layers)
    rng = np.random.default_rng(5)
    lr = rng.standard_normal((1, 3, 8, 9, 16)).astype(np.float32)
    z = rng.standard_normal((1, 32)).astype(np.float32)
    want = np.asarray(G.apply(variables, jnp.asarray(lr), z=jnp.asarray(z)))
    with torch.no_grad():
        got = port(torch.from_numpy(lr), z=torch.from_numpy(z)).numpy()
    assert np.max(np.abs(got - want)) <= 0.05 * np.max(np.abs(want))


def test_sres_chunked_matches_full(sres_pair):
    """Sliding windows with a shared z equal the full-video pass on the same
    frames, with or without enqueue-ahead (tests/test_generators.py)."""
    _, _, port = sres_pair
    rng = np.random.default_rng(6)
    lr = torch.from_numpy(rng.standard_normal((1, 3, 16, 9, 16)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((1, 32)).astype(np.float32))
    with torch.no_grad():
        full = port(lr, z=z)
        chunks = {p: torch.cat(list(generator_sres.sample_video_segments(
            port, lr, segment_length=4, temporal_context=2, z=z, prefetch=p)), dim=2)
            for p in (0, 1, 3)}
    for chunked in chunks.values():
        assert chunked.shape == full.shape == (1, 3, 12, 36, 64)
        np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(chunks[0], chunks[3], rtol=0, atol=0)


def test_sres_draws_z_from_generator(sres_pair):
    _, _, port = sres_pair
    lr = torch.zeros((1, 3, 8, 9, 16))
    with torch.no_grad():
        a = port(lr, generator=torch.Generator().manual_seed(3))
        b = port(lr, generator=torch.Generator().manual_seed(3))
        c = port(lr, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="need z"):
        port(lr)


@pytest.mark.parametrize("seq_length", [5, 8])
def test_lres_forward_matches_jax(lres_pair, seq_length):
    G, variables, port = lres_pair
    rng = np.random.default_rng(7)
    noise = rng.standard_normal(port.noise_shape(2, seq_length)).astype(np.float32)
    want = np.asarray(G.apply(variables, 2, seq_length, noise=jnp.asarray(noise)))
    with torch.no_grad():
        got = port(2, seq_length, noise=torch.from_numpy(noise)).numpy()
    assert got.shape == want.shape == (2, 3, seq_length, 18, 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_lres_bf16_forward_close_to_jax():
    kw = {**LRES_KW, "num_fp16_layers": 4}
    G = jax_lres.VideoGenerator(**kw)
    variables = random_variables(G, 1, 8, seed=8)
    port = generator_lres.VideoGenerator(**kw)
    load_jax_variables(port, variables)
    noise = np.random.default_rng(9).standard_normal(port.noise_shape(1, 8)).astype(np.float32)
    want = np.asarray(G.apply(variables, 1, 8, noise=jnp.asarray(noise)))
    with torch.no_grad():
        got = port(1, 8, noise=torch.from_numpy(noise)).numpy()
    assert np.max(np.abs(got - want)) <= 0.05 * np.max(np.abs(want))


def test_lres_segments_split_the_full_pass(lres_pair):
    _, _, port = lres_pair
    noise = torch.from_numpy(np.random.default_rng(10).standard_normal(
        port.noise_shape(1, 10)).astype(np.float32))
    with torch.no_grad():
        full = port(1, 10, noise=noise)
        segs = list(generator_lres.sample_video_segments(port, 1, 10, segment_length=4,
                                                         noise=noise))
    assert [s.shape[2] for s in segs] == [4, 4, 2]
    torch.testing.assert_close(torch.cat(segs, dim=2), full, rtol=0, atol=0)


def test_init_weights_draw_only_from_the_generator():
    """Random weights come from the given torch.Generator (same seed, same
    weights), and constants keep the JAX initializers' values."""
    from long_video_gan_tpu_torch.models.common import init_weights_

    def build(seed):
        torch.manual_seed(1234 + seed)         # the global RNG must not matter
        return init_weights_(generator_sres.VideoGenerator(**SRES_KW),
                             torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = build(0), build(0), build(1)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    layer = "SG3.synthesis.L0_24_17_32"
    assert not torch.equal(a[f"{layer}.weight"], c[f"{layer}.weight"])
    assert torch.all(a[f"{layer}.affine.bias"] == 1.0)
    assert torch.all(a[f"{layer}.magnitude_ema"] == 1.0)
    assert torch.all(a["SG3.mapping.w_avg"] == 0.0)
    assert a["SG3.mapping.fc0.weight"].std() > 10     # stored as randn / lrate_mul
