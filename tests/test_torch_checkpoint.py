"""`.lvg` reading in the port: the pure-Python msgpack decoder against
`flax.serialization.msgpack_restore`, and generator checkpoints written by the
JAX package's `save_generator` loaded by the port's `load_generator`."""

import json
import struct

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from long_video_gan_tpu.io.checkpoint import save_generator
from long_video_gan_tpu.models import generator_lres as jax_lres
from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch.io.checkpoint import load_checkpoint, load_generator
from long_video_gan_tpu_torch.io.convert_torch import load_jax_variables
from long_video_gan_tpu_torch.io.msgpack_decode import MsgpackError, unpackb
from long_video_gan_tpu_torch.models import generator_lres, generator_sres
from test_torch_generators import LRES_KW, SRES_KW, random_variables


def _random_tree(rng, depth=0):
    """Nested dicts of what flax checkpoints hold: arrays of several dtypes
    and sizes (fix-, 8-, 16- and 32-bit msgpack lengths), numpy scalars and
    plain Python values."""
    tree = {}
    for i in range(int(rng.integers(2, 6))):
        kind = int(rng.integers(0, 9 if depth < 2 else 8))
        key = f"k{i}_" + "x" * int(rng.integers(0, 40))
        shape = tuple(int(s) for s in rng.integers(0, 5, size=int(rng.integers(0, 4))))
        if kind == 0:
            tree[key] = rng.standard_normal(shape).astype(np.float32)
        elif kind == 1:
            tree[key] = jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
        elif kind == 2:
            dtype = (np.int32, np.int64, np.uint8)[int(rng.integers(3))]
            tree[key] = rng.integers(-2**40, 2**40, size=shape).astype(dtype)
        elif kind == 3:
            tree[key] = rng.standard_normal(int(rng.choice([300, 70_000]))).astype(np.float32)
        elif kind == 4:
            tree[key] = np.float32(rng.standard_normal())
        elif kind == 5:
            tree[key] = int(rng.choice([0, 7, -3, 200, -200, 70_000, -70_000, 2**40, -2**40]))
        elif kind == 6:
            tree[key] = float(rng.standard_normal())
        elif kind == 7:
            tree[key] = [None, True, False, "s" * int(rng.integers(0, 300))][int(rng.integers(4))]
        else:
            tree[key] = _random_tree(rng, depth + 1)
    return tree


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        got_a, want_a = np.asarray(got), np.asarray(want)
        assert got_a.shape == want_a.shape
        if want_a.dtype.name == "bfloat16":   # widened to float32, exactly
            assert got_a.dtype == np.float32
            want_a = want_a.astype(np.float32)
        else:
            assert got_a.dtype == want_a.dtype
        np.testing.assert_array_equal(got_a, want_a)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("seed", range(6))
def test_decoder_matches_flax(seed):
    tree = _random_tree(np.random.default_rng(seed))
    blob = serialization.msgpack_serialize(tree)
    _assert_same(unpackb(blob), serialization.msgpack_restore(blob))


def test_decoder_rejects_malformed():
    blob = serialization.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(MsgpackError, match="truncated"):
        unpackb(blob[:-1])
    with pytest.raises(MsgpackError, match="trailing"):
        unpackb(blob + b"\x00")
    with pytest.raises(MsgpackError, match="type byte"):
        unpackb(b"\xc1")


@pytest.fixture(scope="module")
def lvg_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lvg")
    G_l = jax_lres.VideoGenerator(**LRES_KW)
    v_l = random_variables(G_l, 1, 8, seed=11)
    save_generator(str(root / "lres.lvg"), v_l,
                   dict(kind="generator_lres", kwargs={**LRES_KW, "block_remat": True}))
    kw_s = {**SRES_KW, "resample_impl": "auto"}
    G_s = jax_sres.VideoGenerator(**kw_s)
    v_s = random_variables(G_s, jnp.zeros((1, 3, 8, 9, 16)), seed=12)
    save_generator(str(root / "sres.lvg"), v_s,
                   dict(kind="generator_sres", kwargs={**kw_s, "block_remat": False}))
    return root, (G_l, v_l), (G_s, v_s)


def test_load_generator_lres_forward_matches_jax(lvg_files):
    root, (G, variables), _ = lvg_files
    port, config = load_generator(str(root / "lres.lvg"), "cpu")
    assert isinstance(port, generator_lres.VideoGenerator) and not port.training
    assert config["kind"] == "generator_lres"
    noise = np.random.default_rng(13).standard_normal(port.noise_shape(1, 6)).astype(np.float32)
    want = np.asarray(G.apply(variables, 1, 6, noise=jnp.asarray(noise)))
    with torch.no_grad():
        got = port(1, 6, noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)


def test_load_generator_sres_forward_matches_jax(lvg_files):
    root, _, (G, variables) = lvg_files
    port, config = load_generator(str(root / "sres.lvg"), torch.device("cpu"))
    assert isinstance(port, generator_sres.VideoGenerator)
    assert config["kwargs"]["resample_impl"] == "auto"
    rng = np.random.default_rng(14)
    lr = rng.standard_normal((1, 3, 8, 9, 16)).astype(np.float32)
    z = rng.standard_normal((1, 32)).astype(np.float32)
    want = np.asarray(G.apply(variables, jnp.asarray(lr), z=jnp.asarray(z)))
    with torch.no_grad():
        got = port(torch.from_numpy(lr), z=torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)


def test_load_is_strict(lvg_files):
    root = lvg_files[0]
    tree, config = load_checkpoint(str(root / "sres.lvg"))
    port = generator_sres.VideoGenerator(**config["kwargs"])
    load_jax_variables(port, tree)
    # A missing leaf, an extra leaf, or a shape mismatch all raise.
    missing = jax.tree.map(lambda a: a, tree)
    del missing["ema"]["SG3"]["mapping"]["w_avg"]
    with pytest.raises(KeyError, match="w_avg"):
        load_jax_variables(port, missing)
    extra = jax.tree.map(lambda a: a, tree)
    extra["params"]["SG3"]["mapping"]["fc9"] = {"weight": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="fc9"):
        load_jax_variables(port, extra)
    bad = jax.tree.map(lambda a: a, tree)
    bad["params"]["SG3"]["mapping"]["fc0"]["bias"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_variables(port, bad)


def test_rejects_other_files(tmp_path):
    path = tmp_path / "x.lvg"
    path.write_bytes(b"NOTLVG00" + b"\0" * 16)
    with pytest.raises(ValueError, match="not a long_video_gan_tpu checkpoint"):
        load_generator(str(path))
    header = json.dumps({"kind": "discriminator"}).encode()
    path.write_bytes(b"LVGTPU1\0" + struct.pack("<Q", len(header)) + header
                     + serialization.msgpack_serialize({}))
    with pytest.raises(ValueError, match="unknown checkpoint kind"):
        load_generator(str(path))
