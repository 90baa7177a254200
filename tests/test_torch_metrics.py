"""The port's metric plumbing against the JAX package's: dataset-side
statistics through the `stub:16` detector (1e-10), one batch of each
generator sampling protocol with injected lres noise, offset and z (hr video
and features within 1e-3), tiny metrics end to end with the stats cache hit
on the second call, and the cache keyed on the detector that runs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.data.dataset import VideoDataset as JaxVideoDataset
from long_video_gan_tpu.data.dataset import VideoDatasetPerImage as JaxPerImage
from long_video_gan_tpu.io.checkpoint import save_generator
from long_video_gan_tpu.metrics import metric_utils as jax_mu
from long_video_gan_tpu.metrics.detectors import StubDetector as JaxStub
from long_video_gan_tpu.models import generator_lres as jax_lres
from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch.data.tools.synthetic import make_synthetic_dataset
from long_video_gan_tpu_torch.io.checkpoint import load_generator
from long_video_gan_tpu_torch.metrics import metric_main, metric_utils
from long_video_gan_tpu_torch.metrics.metric_main import _compute_fvd, register_metric
from test_torch_generate import LRES_KW, SRES_KW
from test_torch_generators import random_variables
from test_torch_lres_train import one_torch_thread  # noqa: F401

STATS_TOL = 1e-10
GEN_TOL = 1e-3      # of the hr video's max |.|, and of the features'


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A synthetic 8x16 + 32x64 dataset, and tiny lres and sres generators
    with seeded random weights: the JAX modules and variables, and the
    port's modules loaded from their `.lvg` files."""
    root = tmp_path_factory.mktemp("metrics")
    make_synthetic_dataset(str(root / "data"), [(8, 16), (32, 64)], num_videos=3,
                           frames_per_video=12, num_partitions=1)
    G_l = jax_lres.VideoGenerator(**LRES_KW)
    v_l = random_variables(G_l, 1, 8, seed=31)
    save_generator(str(root / "lres.lvg"), v_l, dict(kind="generator_lres", kwargs=LRES_KW))
    G_s = jax_sres.VideoGenerator(**SRES_KW)
    v_s = random_variables(G_s, jnp.zeros((1, 3, 8, 8, 16)), seed=32)
    save_generator(str(root / "sres.lvg"), v_s, dict(kind="generator_sres", kwargs=SRES_KW))
    return dict(root=root, data=str(root / "data"), jax_lres=(G_l, v_l), jax_sres=(G_s, v_s),
                lres=load_generator(str(root / "lres.lvg"), "cpu")[0],
                sres=load_generator(str(root / "sres.lvg"), "cpu")[0])


def _hr(h=32, w=64):
    return dict(height=h, width=w)


# ---------------------------------------------------------------------------
# The dataset side: the same order, clips, bytes and stub features.


@pytest.mark.parametrize("case", ["video", "image"])
def test_dataset_stats_equal_jax(env, tmp_path, case):
    kwargs = dict(dataset_kwargs=dict(dataset_dir=env["data"], seq_length=1, **_hr()),
                  detector="stub:16", batch_size=4, seed=3)
    call = dict(capture_all=True, capture_mean_cov=True, max_items=10)
    if case == "video":
        call.update(seq_length=4, frame_spacing=2)
    want = jax_mu.compute_feature_stats_for_dataset(
        jax_mu.MetricOptions(cache_dir=str(tmp_path / "jax"), **kwargs), "i3d", **call)
    got = metric_utils.compute_feature_stats_for_dataset(
        metric_utils.MetricOptions(cache_dir=str(tmp_path / "port"), device="cpu", **kwargs),
        "i3d", **call)
    assert got.num_items == want.num_items == (3 if case == "video" else 10)
    np.testing.assert_allclose(got.get_all(), want.get_all(), rtol=0, atol=STATS_TOL)
    for a, b in zip(got.get_mean_cov(), want.get_mean_cov()):
        np.testing.assert_allclose(a, b, rtol=0, atol=STATS_TOL)
    assert got.total_weight == pytest.approx(want.total_weight, abs=STATS_TOL)


# ---------------------------------------------------------------------------
# The generator side: one batch of each protocol with injected draws.


class InjectedDraws:
    """`metric_utils.GeneratorDraws` with the draws given: each call takes
    the next value of its kind, which must have the asked-for shape."""

    def __init__(self, noise=(), offsets=(), z=()):
        self.values = {"noise": list(noise), "offset": list(offsets), "z": list(z)}

    def noise(self, shape):
        value = self.values["noise"].pop(0)
        assert value.shape == tuple(shape)
        return torch.from_numpy(value)

    def offset(self, high):
        value = self.values["offset"].pop(0)
        assert 0 <= value < high
        return value

    def z(self, batch, dim):
        value = self.values["z"].pop(0)
        assert value.shape == (batch, dim)
        return torch.from_numpy(value)


def _jax_lres(env, batch, length, noise):
    G_l, v_l = env["jax_lres"]
    return np.asarray(jax.jit(lambda v, n: G_l.apply(v, batch, length, noise=n))(
        v_l, jnp.asarray(noise)))


def _jax_sres(env, lr, z):
    G_s, v_s = env["jax_sres"]
    return np.asarray(jax.jit(lambda v, w, z: G_s.apply(v, w, z=z))(v_s, jnp.asarray(lr),
                                                                   jnp.asarray(z)))


def _compare(got: torch.Tensor, want: np.ndarray, seq_length: int) -> None:
    """The hr video, then the stub features of its uint8 frames."""
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GEN_TOL * np.abs(want).max()
    stub = JaxStub(16)
    clip = (lambda v: v) if seq_length > 1 else (lambda v: v[:, :, 0])
    f_got = stub(clip(metric_utils._to_uint8(got[:, :, :seq_length])))
    f_want = stub(clip(jax_mu._to_uint8(want[:, :, :seq_length])))
    assert np.abs(f_got - f_want).max() <= GEN_TOL * np.abs(f_want).max()


def test_two_stage_batch_matches_jax(env):
    gen_len, batch, ctx = 4, 2, SRES_KW["temporal_context"]
    lres, sres = env["lres"], env["sres"]
    lr_len = gen_len + 2 * ctx + lres.total_temporal_scale
    rng = np.random.default_rng(33)
    noise = rng.standard_normal(lres.noise_shape(batch, lr_len)).astype(np.float32)
    off = 3
    z = rng.standard_normal((batch, sres.latent_z_dim)).astype(np.float32)
    opts = metric_utils.MetricOptions(G=sres, lr_G=lres, device="cpu")
    video, weights = next(metric_utils.generator_batches(
        opts, gen_len, batch, True, InjectedDraws([noise], [off], [z])))
    assert weights is None

    lr = _jax_lres(env, batch, lr_len, noise)
    want = _jax_sres(env, lr[:, :, off:off + gen_len + 2 * ctx], z)
    _compare(video, want, gen_len)


@pytest.mark.parametrize("case", ["video", "image"])
def test_cond_dataset_batch_matches_jax(env, case):
    """The sres G on real lr clips, drawn from the cond dataset in the JAX
    package's order (`default_rng(seed + 1)`); image metrics carry each
    window's per-video weight."""
    video_metric = case == "video"
    gen_len, batch, ctx, seed = (4 if video_metric else 1), 3, SRES_KW["temporal_context"], 5
    z = np.random.default_rng(34).standard_normal((batch, 32)).astype(np.float32)
    cond = dict(dataset_dir=env["data"], seq_length=1, height=8, width=16)
    opts = metric_utils.MetricOptions(G=env["sres"], cond_dataset_kwargs=cond, seed=seed,
                                      device="cpu")
    video, weights = next(metric_utils.generator_batches(opts, gen_len, batch, video_metric,
                                                         InjectedDraws(z=[z])))

    rng = np.random.default_rng(seed + 1)
    cls = JaxVideoDataset if video_metric else JaxPerImage
    ds = cls(**dict(cond, seq_length=gen_len + 2 * ctx))
    order = rng.permutation(len(ds))
    items = [ds.sample(int(order[i % len(order)]), rng) for i in range(batch)]
    want = _jax_sres(env, np.stack([it["video"] for it in items]), z)
    _compare(video, want, gen_len)
    if video_metric:
        assert weights is None
    else:
        np.testing.assert_array_equal(
            weights, [1.0 / it["num_samples_from_source"] for it in items])


def test_single_stage_batch_matches_jax(env):
    gen_len, batch = 4, 2
    lres = env["lres"]
    lr_len = gen_len + lres.total_temporal_scale
    noise = np.random.default_rng(35).standard_normal(
        lres.noise_shape(batch, lr_len)).astype(np.float32)
    off = 5
    opts = metric_utils.MetricOptions(G=lres, device="cpu")
    video, _ = next(metric_utils.generator_batches(opts, gen_len, batch, True,
                                                   InjectedDraws([noise], [off])))
    want = _jax_lres(env, batch, lr_len, noise)
    _compare(video, want[:, :, off:off + gen_len], gen_len)


def test_generator_draws_are_seeded():
    a, b, c = (metric_utils.GeneratorDraws(s) for s in (7, 7, 8))
    draws = [(d.noise((2, 3, 4)), d.offset(9), d.z(2, 5)) for d in (a, b, c)]
    for x, y in zip(draws[0], draws[1]):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert not torch.equal(draws[0][0], draws[2][0])


# ---------------------------------------------------------------------------
# Metrics end to end, and the stats cache.


def _register_tiny_fvd():
    if not metric_main.is_valid_metric("fvd_tiny_test"):
        @register_metric
        def fvd_tiny_test(opts):
            return dict(fvd_tiny_test=_compute_fvd(opts, max_real=6, num_gen=6, num_frames=4))


@pytest.mark.parametrize("protocol,metric", [("two_stage", "fvd_tiny_test"),
                                             ("cond_dataset", "fid50k_full"),
                                             ("cond_dataset", "is50k"),
                                             ("single_stage", "fvd_tiny_test")])
def test_tiny_metrics_end_to_end(env, tmp_path, monkeypatch, protocol, metric):
    """fvd (a registered 4-frame variant of fvd2048_16f's code path), fid
    and is through the protocols: finite, and a metric's second call takes
    its dataset statistics from the cache."""
    _register_tiny_fvd()
    hr = protocol != "single_stage"
    kwargs = dict(G=env["sres"] if hr else env["lres"], detector="stub:16", batch_size=4,
                  max_items_override=20 if metric == "is50k" else 6,
                  cache_dir=str(tmp_path / "cache"), device="cpu",
                  dataset_kwargs=dict(dataset_dir=env["data"], seq_length=1,
                                      **(_hr() if hr else _hr(8, 16))))
    if protocol == "two_stage":
        kwargs["lr_G"] = env["lres"]
    elif protocol == "cond_dataset":
        kwargs["cond_dataset_kwargs"] = dict(dataset_dir=env["data"], seq_length=1, height=8,
                                             width=16)
    if metric == "is50k":
        result = metric_main.calc_metric(metric=metric, **kwargs)["results"]
        assert result["is50k_mean"] >= 1.0 and np.isfinite(result["is50k_std"])
        return
    loads = []
    load = metric_utils.FeatureStats.load
    monkeypatch.setattr(metric_utils.FeatureStats, "load",
                        classmethod(lambda cls, path: loads.append(path) or load(path)))
    first = metric_main.calc_metric(metric=metric, **kwargs)["results"][metric]
    assert np.isfinite(first) and first >= 0 and not loads
    second = metric_main.calc_metric(metric=metric, **kwargs)["results"][metric]
    assert len(loads) == 1 and second == pytest.approx(first)


def test_stats_cache_is_keyed_on_the_detector_that_runs(env, tmp_path):
    """A `stub:16` run of an "i3d" metric does not serve a later run with
    another detector: the port keys the cache on `opts.detector or spec`.
    The JAX package keys it on the spec alone and serves the stale
    statistics (ROADMAP.md, Queue 3)."""
    dataset = dict(dataset_dir=env["data"], seq_length=1, **_hr())
    call = dict(capture_mean_cov=True, max_items=4)
    for mu, extra in ((metric_utils, dict(device="cpu")), (jax_mu, {})):
        cache = str(tmp_path / mu.__name__)
        first = mu.compute_feature_stats_for_dataset(
            mu.MetricOptions(dataset_kwargs=dataset, detector="stub:16", cache_dir=cache, **extra),
            "i3d", **call)
        second = mu.compute_feature_stats_for_dataset(
            mu.MetricOptions(dataset_kwargs=dataset, detector="stub:8", cache_dir=cache, **extra),
            "i3d", **call)
        assert first.num_features == 16
        if mu is metric_utils:
            assert second.num_features == 8
        else:
            assert second.num_features == 16     # the JAX key's stale hit


def test_default_cache_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("LVG_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    port = metric_utils.MetricOptions().cache_path("dataset-stats", detector="i3d")
    jax_path = jax_mu.MetricOptions().cache_path("dataset-stats", detector="i3d")
    assert port.startswith(str(tmp_path / ".cache" / "long_video_gan_tpu_torch" / "metric_stats"))
    assert jax_path.startswith(str(tmp_path / ".cache" / "long_video_gan_tpu" / "metric_stats"))
    monkeypatch.setenv("LVG_CACHE_DIR", str(tmp_path / "c"))
    assert metric_utils.MetricOptions().cache_path("x").startswith(
        str(tmp_path / "c" / "long_video_gan_tpu_torch"))
    assert not jax_mu.MetricOptions().cache_path("x").startswith(
        str(tmp_path / "c" / "long_video_gan_tpu_torch"))
