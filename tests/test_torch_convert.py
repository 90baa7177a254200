"""Checkpoint conversion in the port (`io/convert_torch.py`,
`convert_checkpoint.py`) against the JAX package's: a state_dict in the
reference's layout, made from seeded JAX variables through
`flax_path_to_torch_key` (plus static filter buffers the converters skip),
pickled as the reference's G_ema files are (an object with `state_dict()`
and `init_kwargs`), becomes byte-equal `.lvg` files under both CLIs, lres
and sres; both converters raise alike on a missing entry, an unused entry
and a shape mismatch."""

import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from long_video_gan_tpu.io.convert_torch import flax_path_to_torch_key, torch_state_to_variables
from long_video_gan_tpu.models import generator_lres as jax_lres
from long_video_gan_tpu.models import generator_sres as jax_sres
from long_video_gan_tpu_torch import convert_checkpoint
from long_video_gan_tpu_torch.io.checkpoint import load_generator
from long_video_gan_tpu_torch.io.convert_torch import (load_reference_pickle_state,
                                                       load_reference_state)
from long_video_gan_tpu_torch.models import generator_lres, generator_sres
from test_torch_generators import LRES_KW, SRES_KW, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Static buffers of the reference that both converters rebuild and skip.
SKIPPED = {"synthesis.L0_36_20_32.up_filter": (12,), "temporal_emb.blur_filters": (3, 16)}


class ReferencePickle:
    """What a reference G_ema pickle unpickles to, for the converters: an
    object with `state_dict()` and `init_kwargs`."""

    def __init__(self, state: dict, init_kwargs: dict):
        self._state = state
        self.init_kwargs = init_kwargs

    def state_dict(self):
        return dict(self._state)


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_convert_checkpoint",
                                                  os.path.join(REPO, "convert_checkpoint.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _case(kind: str):
    """(JAX module, its init args, init_kwargs, the port's class)."""
    if kind == "lres":
        return jax_lres.VideoGenerator(**LRES_KW), (1, 8), LRES_KW, generator_lres.VideoGenerator
    G = jax_sres.VideoGenerator(**SRES_KW)
    return (G, (jnp.zeros((1, 3, 1 + 2 * G.temporal_context, 9, 16)),), SRES_KW,
            generator_sres.VideoGenerator)


def reference_state(kind: str, seed: int = 0) -> dict:
    """A reference-layout state_dict of seeded values, every collection of
    the JAX variables flattened to torch keys, plus skipped filter buffers."""
    G, args, _, _ = _case(kind)
    variables = random_variables(G, *args, seed=seed)
    state = {flax_path_to_torch_key(tuple(k.key for k in path)[1:]): torch.from_numpy(
        np.array(leaf)) for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}
    rng = np.random.default_rng(seed + 1)
    state.update({k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for k, s in SKIPPED.items()})
    return state


@pytest.mark.parametrize("kind", ["lres", "sres"])
def test_both_converters_write_the_same_bytes(kind, tmp_path):
    state = reference_state(kind)
    _, _, init_kwargs, _ = _case(kind)
    pkl = tmp_path / "G_ema.pkl"
    with open(pkl, "wb") as fp:
        pickle.dump(ReferencePickle(state, init_kwargs), fp)
    _jax_cli().main.main(args=["--pkl", str(pkl), "--kind", kind, "--output",
                               str(tmp_path / "jax.lvg"), "--reference", str(tmp_path)],
                         standalone_mode=False)
    convert_checkpoint.main(["--pkl", str(pkl), "--kind", kind, "--output",
                             str(tmp_path / "port.lvg")])
    want = (tmp_path / "jax.lvg").read_bytes()
    assert (tmp_path / "port.lvg").read_bytes() == want and len(want) > 1000
    G, config = load_generator(str(tmp_path / "port.lvg"))
    assert config == {"kind": f"generator_{kind}", "kwargs": init_kwargs}
    for key, value in G.state_dict().items():
        assert torch.equal(value, state[key]), key


@pytest.mark.parametrize("fault, error, match", [
    ("missing", KeyError, "has no entry for"),
    ("unused", KeyError, "unconverted torch entries"),
    ("shape", ValueError, "shape mismatch for"),
])
@pytest.mark.parametrize("kind", ["lres", "sres"])
def test_both_converters_are_strict(kind, fault, error, match):
    state = reference_state(kind)
    G_j, args, init_kwargs, port_cls = _case(kind)
    key = sorted(k for k in state if k.endswith(".weight"))[0]
    if fault == "missing":
        del state[key]
    elif fault == "unused":
        state["mapping.extra.weight"] = torch.zeros(3)
    else:
        state[key] = torch.zeros(tuple(state[key].shape) + (1,))
    shapes = jax.eval_shape(lambda: G_j.init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, *args))
    with pytest.raises(error, match=match):
        torch_state_to_variables(state, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                                     shapes))
    with pytest.raises(error, match=match):
        load_reference_state(port_cls(**init_kwargs), state)


def test_load_reference_pickle_state(tmp_path):
    state = {"a.weight": torch.arange(6.0).reshape(2, 3), "b.magnitude_ema": torch.ones(())}
    path = tmp_path / "ref.pkl"
    with open(path, "wb") as fp:
        pickle.dump(ReferencePickle(state, {"out_height": 18}), fp)
    got, init_kwargs = load_reference_pickle_state(str(path))
    assert init_kwargs == {"out_height": 18}
    assert got.keys() == state.keys() and all(torch.equal(got[k], state[k]) for k in state)
    assert "pkg_resources" in sys.modules      # the shim the reference's pickles need
    assert sys.modules["pkg_resources"].parse_version("2.1") > \
        sys.modules["pkg_resources"].parse_version("2.0")
