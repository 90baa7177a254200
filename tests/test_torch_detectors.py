"""The port's detector networks, their converters and preprocessing against
the JAX package's.

Each network body comes from the repository's torch fixtures (the published
layouts built in tests/test_i3d.py, test_inception_v3.py and test_c3d.py),
with random weights and batch-norm statistics, traced to disk and loaded by
both packages' converters; the port's module and the JAX package's flax
module then run the same seeded input, each at the smallest input its JAX
body accepts (I3D 8x32x32, Inception 75x75; C3D at 16x112x112, which its
fc6 fixes). The preprocessing stages (rescale, antialiased bilinear resize,
crop, BGR means) are held to `jax.image.resize` at the shapes the metric
protocols give them, and `get_detector`'s dispatch to tests/test_detectors.py.
"""

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from long_video_gan_tpu.metrics import c3d as jax_c3d
from long_video_gan_tpu.metrics import i3d as jax_i3d
from long_video_gan_tpu.metrics import inception_v3 as jax_inception
from long_video_gan_tpu_torch.metrics import detectors
from long_video_gan_tpu_torch.metrics.c3d import C3D, C3DDetector, c3d_state_dict
from long_video_gan_tpu_torch.metrics.common import load_weights, resize, resize_weights
from long_video_gan_tpu_torch.metrics.detectors import (StubDetector, TorchscriptDetector,
                                                        get_detector)
from long_video_gan_tpu_torch.metrics.i3d import I3DDetector, InceptionI3d, i3d_state_dict
from long_video_gan_tpu_torch.metrics.inception_v3 import InceptionDetector
from test_c3d import TC3D
from test_i3d import TI3D
from test_inception_v3 import TInceptionV3

BODY_TOL = 1e-3     # of the output's max |.|: the two frameworks' f32 convs
RESIZE_TOL = 1e-3   # on the 0-255 scale


def _randomize_norms(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.copy_(0.02 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.8 + 0.4 * torch.rand(m.running_var.shape, generator=gen))
    return module.eval()


def _traced(module: torch.nn.Module, example_shape, path) -> str:
    with torch.no_grad():
        torch.jit.trace(module, torch.zeros(example_shape)).save(str(path))
    return str(path)


def _assert_close(got: torch.Tensor, want, what: str) -> None:
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= BODY_TOL, f"{what}: {err:.2e} of max |.|"


@pytest.fixture(scope="module")
def i3d_file(tmp_path_factory):
    torch.manual_seed(0)
    model = _randomize_norms(TI3D(), 1)
    return _traced(model, (1, 3, 8, 32, 32), tmp_path_factory.mktemp("i3d") / "i3d.pt")


@pytest.mark.parametrize("names", ["published", "unfamiliar"])
def test_i3d_body_matches_jax(i3d_file, names):
    """Both converters on the traced file (its own key names, or the same
    tensors under names that only registration order and shape identify),
    then both bodies on one 8x32x32 video."""
    state = torch.jit.load(i3d_file).state_dict()
    if names == "unfamiliar":
        state = {f"w{i:03d}": v for i, v in enumerate(state.values())}
    video = np.random.default_rng(2).standard_normal((2, 3, 8, 32, 32)).astype(np.float32) * 0.5
    want_feats, want_logits = jax.jit(jax_i3d.InceptionI3d().apply)(
        jax_i3d.i3d_variables_from_state_dict(state), jnp.asarray(video))
    module = load_weights(InceptionI3d(), i3d_state_dict(state)).eval()
    with torch.no_grad():
        feats, logits = module(torch.from_numpy(video))
    assert feats.shape == (2, 1024) and logits.shape == (2, 400)
    _assert_close(feats, want_feats, "I3D features")
    _assert_close(logits, want_logits, "I3D logits")


def test_i3d_converter_takes_a_uniform_prefix_and_refuses_strangers(i3d_file):
    state = torch.jit.load(i3d_file).state_dict()
    converted = i3d_state_dict({f"model.{k}": v for k, v in state.items()})
    assert set(converted) == {k for k in state if "num_batches_tracked" not in k}
    with pytest.raises(ValueError, match="unrecognized I3D key"):
        i3d_state_dict(dict(state, **{"Mixed_3b.b0.extra.weight": torch.zeros(1)}))


def test_inception_body_matches_jax(tmp_path):
    torch.manual_seed(3)
    model = _randomize_norms(TInceptionV3(), 4)
    path = _traced(model, (1, 3, 75, 75), tmp_path / "inception.pt")
    state = torch.jit.load(path).state_dict()
    images = np.random.default_rng(5).standard_normal((2, 3, 75, 75)).astype(np.float32) * 0.5
    want_feats, want_logits = jax.jit(jax_inception.InceptionV3().apply)(
        jax_inception.inception_variables_from_state_dict(state), jnp.asarray(images))
    det = InceptionDetector.from_torchscript(path, "cpu")
    with torch.no_grad():
        feats, logits = det.module(torch.from_numpy(images))
    assert feats.shape == (2, 2048) and logits.shape == (2, 1008)
    _assert_close(feats, want_feats, "Inception features")
    _assert_close(logits, want_logits, "Inception logits")

    # A pickled module (the published file is a .pkl) loads with pickle.load
    # and converts to the same weights.
    pkl = tmp_path / "inception-2015-12-05.pkl"
    with open(pkl, "wb") as fp:
        pickle.dump(model, fp)
    from_pkl = get_detector(str(pkl), "cpu")
    assert isinstance(from_pkl, InceptionDetector)
    for k, v in det.module.state_dict().items():
        assert torch.equal(from_pkl.module.state_dict()[k], v), k


@pytest.fixture(scope="module")
def c3d_file(tmp_path_factory):
    torch.manual_seed(6)
    return _traced(TC3D().eval(), (1, 3, 16, 112, 112), tmp_path_factory.mktemp("c3d") / "c3d.pt")


@pytest.mark.parametrize("names", ["published", "unfamiliar"])
def test_c3d_body_matches_jax(c3d_file, names):
    state = torch.jit.load(c3d_file).state_dict()
    if names == "unfamiliar":
        state = {f"layer{i}.w": v for i, v in enumerate(state.values())}
    video = np.random.default_rng(7).standard_normal((1, 3, 16, 112, 112)).astype(np.float32) * 20
    want_feats, want_logits = jax.jit(jax_c3d.C3D().apply)(
        jax_c3d.c3d_variables_from_state_dict(state), jnp.asarray(video))
    module = load_weights(C3D(), c3d_state_dict(state)).eval()
    with torch.no_grad():
        feats, logits = module(torch.from_numpy(video))
    assert feats.shape == (1, 4096) and logits.shape == (1, 101)
    _assert_close(feats, want_feats, "C3D features")
    _assert_close(logits, want_logits, "C3D logits")


# ---------------------------------------------------------------------------
# Preprocessing at the protocols' shapes: lres frames (36x64) and sres frames
# (144x256) into each detector. Downsampling (I3D's width, both of C3D's
# axes) is where an unantialiased resize goes wrong.

def _video(shape, seed=8):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("size", [(36, 64), (144, 256)])
def test_i3d_preprocess_matches_jax(size):
    video = _video((2, 3, 2) + size)
    want = jax.image.resize(jnp.asarray(video, jnp.float32) / 127.5 - 1.0,
                            (2, 3, 2, 224, 224), method="bilinear")
    got = I3DDetector.preprocess(torch.from_numpy(video))
    err = np.abs(got.numpy() - np.asarray(want)).max() * 127.5
    assert err <= RESIZE_TOL, err


@pytest.mark.parametrize("size", [(36, 64), (144, 256)])
def test_inception_preprocess_matches_jax(size):
    images = _video((2, 3) + size)
    want = jax.image.resize(jnp.asarray(images, jnp.float32), (2, 3, 299, 299),
                            method="bilinear") / 127.5 - 1.0
    got = InceptionDetector.preprocess(torch.from_numpy(images))
    err = np.abs(got.numpy() - np.asarray(want)).max() * 127.5
    assert err <= RESIZE_TOL, err


@pytest.mark.parametrize("size", [(36, 64), (144, 256)])
def test_c3d_preprocess_matches_jax(size):
    video = _video((1, 3, 2) + size)
    x = jax.image.resize(jnp.asarray(video, jnp.float32), (1, 3, 2, 128, 171),
                         method="bilinear")
    x = x[:, :, :, 8:120, 29:141]
    want = x[:, ::-1] - jnp.asarray(jax_c3d._MEAN[::-1]).reshape(1, 3, 1, 1, 1)
    got = C3DDetector.preprocess(torch.from_numpy(video))
    assert got.shape == (1, 3, 2, 112, 112)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= RESIZE_TOL


@pytest.mark.parametrize("size,out", [((36, 64), (299, 299)), ((144, 256), (299, 299)),
                                      ((144, 256), (224, 224)), ((144, 256), (128, 171))])
def test_resize_is_jax_image_resize(size, out):
    """The resize alone: within RESIZE_TOL of `jax.image.resize` and within
    1e-4 of its weights applied in float64; `F.interpolate` without
    antialiasing matches only where both axes grow."""
    x = np.random.default_rng(9).random((2, 3) + size).astype(np.float32) * 255
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + out, method="bilinear"))
    got = resize(torch.from_numpy(x), out).numpy()
    assert np.abs(got - want).max() <= RESIZE_TOL
    exact = (resize_weights(size[0], out[0]).T.astype(np.float64)
             @ (x.astype(np.float64) @ resize_weights(size[1], out[1])))
    assert np.abs(got - exact).max() <= 1e-4
    plain = F.interpolate(torch.from_numpy(x), size=out, mode="bilinear",
                          align_corners=False).numpy()
    shrinks = out[0] < size[0] or out[1] < size[1]
    assert (np.abs(plain - want).max() > 1.0) == shrinks


# ---------------------------------------------------------------------------
# get_detector's dispatch (tests/test_detectors.py's cases).


class _TinyNet(torch.nn.Module):
    """A torchscript-able module that is NOT any known detector topology."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 3)

    def forward(self, x):
        return self.fc(x.float().flatten(2).mean(dim=2))


@pytest.fixture()
def tiny_ts(tmp_path):
    def save(name: str) -> str:
        path = str(tmp_path / name)
        with torch.no_grad():
            torch.jit.script(_TinyNet()).save(path)
        return path

    return save


@pytest.fixture(autouse=True)
def clear_cache():
    get_detector.cache_clear()
    yield
    get_detector.cache_clear()


def test_stub_spec_equals_jax():
    from long_video_gan_tpu.metrics.detectors import StubDetector as JaxStub

    det = get_detector("stub:16", "cpu")
    assert isinstance(det, StubDetector)
    batch = _video((2, 3, 4, 8, 8))
    np.testing.assert_array_equal(det(batch), JaxStub(16)(batch))
    np.testing.assert_array_equal(det(batch, return_probs=True),
                                  JaxStub(16)(batch, return_probs=True))


def test_misleading_substring_name_is_not_converted(tiny_ts, capsys):
    path = tiny_ts("c3d_from_i3d_rig.pt")
    det = get_detector(path, "cpu")
    assert isinstance(det, TorchscriptDetector)
    out = capsys.readouterr().out
    assert "unrecognized file name" in out
    assert "conversion" not in out
    assert det(np.ones((2, 4, 3), np.uint8)).shape == (2, 3)


def test_explicit_family_prefix_forces_conversion_attempt(tiny_ts, capsys):
    path = tiny_ts("whatever.pt")
    det = get_detector(f"i3d:{path}", "cpu")
    assert isinstance(det, TorchscriptDetector)
    assert det.forward_kwargs == dict(rescale=True, resize=True, return_features=True)
    assert "native conversion failed" in capsys.readouterr().out


def test_exact_published_basename_routes_to_family(tiny_ts, capsys):
    path = tiny_ts("i3d_torchscript.pt")
    assert isinstance(get_detector(path, "cpu"), TorchscriptDetector)
    assert "i3d native conversion failed" in capsys.readouterr().out


def test_bare_family_name_resolves_in_detector_dir(tmp_path, monkeypatch, i3d_file, capsys):
    monkeypatch.setenv(detectors.DETECTOR_DIR_ENV, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="c3d"):
        get_detector("c3d", "cpu")
    (tmp_path / "i3d.pt").write_bytes(open(i3d_file, "rb").read())
    det = get_detector("i3d", "cpu")
    assert isinstance(det, I3DDetector) and det.device == torch.device("cpu")
    assert "native i3d on cpu" in capsys.readouterr().out
    feats = det(_video((1, 3, 8, 32, 32)))
    assert feats.shape == (1, 400) and np.isfinite(feats).all()


def test_missing_path_raises():
    with pytest.raises(FileNotFoundError):
        get_detector("/nonexistent/detector.pt", "cpu")
    with pytest.raises(FileNotFoundError):
        get_detector("i3d:/nonexistent/i3d.pt", "cpu")
