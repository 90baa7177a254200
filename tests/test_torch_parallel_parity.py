"""The port's parallel layer against the JAX package's, on the CPU.

- `parallel.temporal._window_video_from_noise` against JAX's on the same
  numpy noise and weights (tests/test_temporal_sharding.py's tiny G);
- `MinibatchStdLayer` on a global batch against JAX's;
- `synthesize_time_sharded` on 2 and 4 gloo ranks (processes of
  tests/test_torch_parallel.py, which import no jax) against the unsharded
  port forward over the same noise, by G in float32 and by a float64 copy,
  at tests/test_temporal_sharding.py's tolerance, and its assertions.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.models import discriminator_sres as jax_dsres
from long_video_gan_tpu.models.generator_lres import VideoGenerator as JaxVideoGenerator
from long_video_gan_tpu.parallel import temporal as jax_temporal
from long_video_gan_tpu_torch.io.convert_torch import load_jax_variables
from long_video_gan_tpu_torch.models.discriminator_sres import MinibatchStdLayer
from long_video_gan_tpu_torch.models.generator_lres import VideoGenerator
from long_video_gan_tpu_torch.parallel import temporal
from test_torch_generators import random_variables
from test_torch_parallel import TEMPORAL_G, spawn, temporal_G, temporal_models


@pytest.mark.parametrize("window_len", [32, 96])
def test_window_video_matches_jax(window_len):
    G_j = JaxVideoGenerator(**TEMPORAL_G)
    variables = random_variables(G_j, 1, 8, seed=21)
    G_t = VideoGenerator(**TEMPORAL_G)
    load_jax_variables(G_t, variables)
    noise = np.random.default_rng(22).standard_normal(
        G_t.noise_shape(2, window_len)).astype(np.float32)
    want = np.asarray(jax_temporal._window_video_from_noise(G_j, variables, jnp.asarray(noise),
                                                            window_len))
    with torch.no_grad():
        got = temporal._window_video_from_noise(G_t, torch.from_numpy(noise), window_len)
    assert got.shape == want.shape == (2, 3, window_len, 8, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("group_size,num_channels", [(4, 1), (2, 2), (None, 1)])
def test_minibatch_std_matches_jax(group_size, num_channels):
    x = np.random.default_rng(23).standard_normal((8, 4, 3, 5)).astype(np.float32)
    layer = jax_dsres.MinibatchStdLayer(group_size, num_channels)
    want = np.asarray(layer.apply({}, jnp.asarray(x)))
    got = MinibatchStdLayer(group_size, num_channels)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (8, 4 + num_channels, 3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_time_sharded_synthesis_matches_unsharded(world, tmp_path):
    """G in float32 and a float64 copy of it, each against the unsharded pass
    of the same G."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spawn([__file__.replace("_parity", ""), "temporal", str(tmp_path)], world=world)
        G = temporal_G()
        scale = G.total_temporal_scale
        seq_length, halo = scale * world, 8 * scale
        # The unsharded oracle: the covering window over the same noise stream,
        # its interior.
        noise_len_w = G.noise_shape(1, scale + 2 * halo)[2]
        noise = torch.randn((1, G.noise_channels, (world - 1) * scale + noise_len_w),
                            generator=torch.Generator().manual_seed(7))
        with torch.no_grad():
            want = {name: temporal._window_video_from_noise(
                model, noise, seq_length + 2 * halo)[:, :, halo:halo + seq_length].numpy()
                    for name, model in temporal_models().items()}
    finally:
        torch.set_num_threads(threads)
    videos = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    assert videos[0].keys() == want.keys()
    for name, video in videos[0].items():
        assert video.shape == (1, 3, seq_length, 8, 16)
        for other in videos[1:]:
            np.testing.assert_array_equal(other[name].numpy(), video.numpy())
        np.testing.assert_allclose(video.numpy(), want[name], rtol=1e-4, atol=2e-6)


def test_time_sharded_assertions():
    G = temporal_G()
    with pytest.raises(AssertionError, match="divisible"):
        temporal.synthesize_time_sharded(G, 1, 48, torch.Generator())
    with pytest.raises(AssertionError, match="halo"):
        temporal.synthesize_time_sharded(G, 1, 64, torch.Generator(), halo=40)
