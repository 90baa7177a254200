"""The port's feature statistics and distances against the JAX package's on
the same seeded features: FeatureStats (plain, weighted, capped), Fréchet
distance, KID and IS within 1e-10, and each package loading the other's
stats `.npz`."""

import numpy as np
import pytest

from long_video_gan_tpu.metrics import feature_stats as jax_fs
from long_video_gan_tpu_torch.metrics import feature_stats as port_fs

TOL = 1e-10


def _features(seed: int, n: int = 300, dim: int = 24, shift: float = 0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((dim, dim)) / np.sqrt(dim)
    return (rng.standard_normal((n, dim)) @ mix + shift).astype(np.float32)


def _stats(module, x, weights=None, max_items=None, chunk=64):
    stats = module.FeatureStats(capture_all=True, capture_mean_cov=True, max_items=max_items)
    for i in range(0, len(x), chunk):
        stats.append(x[i:i + chunk], None if weights is None else weights[i:i + chunk])
    return stats


@pytest.mark.parametrize("case", ["plain", "weighted", "capped"])
def test_feature_stats_match_jax(case):
    x = _features(0)
    weights = np.random.default_rng(1).uniform(0.1, 1.0, len(x)) if case == "weighted" else None
    max_items = 200 if case == "capped" else None
    want, got = _stats(jax_fs, x, weights, max_items), _stats(port_fs, x, weights, max_items)
    assert got.num_items == want.num_items == (200 if case == "capped" else 300)
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.get_all(), want.get_all())


def test_distances_match_jax():
    real, gen = _features(2), _features(3, shift=0.3)
    stats = [(_stats(m, real).get_mean_cov(), _stats(m, gen).get_mean_cov())
             for m in (jax_fs, port_fs)]
    (rj, gj), (rp, gp) = stats
    fid_j = jax_fs.frechet_distance(*gj, *rj)
    fid_p = port_fs.frechet_distance(*gp, *rp)
    assert fid_j > 0.1
    assert abs(fid_p - fid_j) <= TOL * max(1.0, abs(fid_j))
    assert abs(port_fs.frechet_distance(*rp, *rp)) < 1e-6

    kid_j = jax_fs.kid_from_features(real, gen, num_subsets=20, max_subset_size=100, seed=4)
    kid_p = port_fs.kid_from_features(real, gen, num_subsets=20, max_subset_size=100, seed=4)
    assert abs(kid_p - kid_j) <= TOL * max(1.0, abs(kid_j))

    logits = _features(5, dim=10) * 3
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    for a, b in zip(port_fs.inception_score_from_probs(probs),
                    jax_fs.inception_score_from_probs(probs)):
        assert abs(a - b) <= TOL * max(1.0, abs(b))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_loads_the_others_stats(writer, tmp_path):
    mods = {"jax": jax_fs, "port": port_fs}
    reader = mods["port" if writer == "jax" else "jax"]
    x = _features(6)
    stats = _stats(mods[writer], x, max_items=250)
    path = str(tmp_path / "stats.npz")
    stats.save(path)
    loaded = reader.FeatureStats.load(path)
    assert type(loaded) is reader.FeatureStats
    assert loaded.is_full() and loaded.num_items == 250
    for a, b in zip(loaded.get_mean_cov(), stats.get_mean_cov()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(loaded.get_all(), stats.get_all())
