"""Convert between the JAX package's variable trees and the port's modules.

Counterpart of `long_video_gan_tpu/io/convert_torch.py`, both ways:
  * `load_jax_variables`: a flax variable tree ({"params", "ema", "consts"}
    of arrays, as a `.lvg` body or `jax.device_get` gives it) becomes the
    module's state_dict. Each leaf's key is `flax_path_to_torch_key` of its
    path without the collection. Strict both ways: a key missing on either
    side, or a shape mismatch, raises.
  * `module_to_variables`: the module's state_dict becomes a flax variable
    tree of float32 numpy arrays, for the `.lvg` writer. Parameters go to
    "params", the SynthesisInput's drawn-once `features` to "consts", and the
    other persistent buffers (magnitude EMAs, w_avg) to "ema".
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

# Container names whose `name_N` flax submodules are torch ModuleLists
# (`name.N`): the JAX package converter's, and the lres discriminator
# epilogue's `conv1d_N` / `linear_N`.
MODULE_LIST_NAMES = ("temporal_layers", "spatial_layers", "blocks", "resamples", "conv1d",
                     "linear")

_CONST_BUFFERS = ("features",)


def flax_path_to_torch_key(path: tuple[str, ...]) -> str:
    """Map a flax variable path (collection stripped) to a torch state_dict key."""
    parts = []
    for seg in path:
        m = re.fullmatch(r"(.+)_(\d+)", seg)
        if m and m.group(1) in MODULE_LIST_NAMES:
            parts.extend([m.group(1), m.group(2)])
        else:
            parts.append(seg)
    return ".".join(parts)


def torch_key_to_flax_path(key: str) -> tuple[str, ...]:
    """The inverse of `flax_path_to_torch_key`."""
    parts = key.split(".")
    path = []
    i = 0
    while i < len(parts):
        if parts[i] in MODULE_LIST_NAMES and i + 1 < len(parts) and parts[i + 1].isdigit():
            path.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    return tuple(path)


def flatten_variables(variables: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """{torch key: array} over every collection of a flax variable tree."""
    out: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        key = flax_path_to_torch_key(path[1:])
        if key in out:
            raise KeyError(f"variable {key} appears in two collections")
        out[key] = np.asarray(node)

    walk(variables, ())
    return out


def load_jax_variables(module: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Copy a flax variable tree into `module` (parameters and buffers)."""
    arrays = flatten_variables(variables)
    state = module.state_dict()
    missing = sorted(set(state) - set(arrays))
    unexpected = sorted(set(arrays) - set(state))
    if missing or unexpected:
        raise KeyError(f"variable tree does not match the module: missing {missing[:10]}, "
                       f"unexpected {unexpected[:10]}")
    new_state = {}
    for key, target in state.items():
        value = arrays[key]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint {tuple(value.shape)} "
                             f"vs module {tuple(target.shape)}")
        # Copies: `.lvg` arrays are read-only views of the file buffer.
        new_state[key] = torch.from_numpy(np.array(value) if value.dtype.kind in "iub"
                                          else np.array(value, dtype=np.float32))
    module.load_state_dict(new_state, strict=True)


def module_to_variables(module: torch.nn.Module) -> dict:
    """The module's parameters and persistent buffers as a flax variable
    tree of numpy arrays (the inverse of `load_jax_variables`)."""
    param_names = {name for name, _ in module.named_parameters()}
    tree: dict = {}
    for key, value in module.state_dict().items():
        if key in param_names:
            collection = "params"
        elif key.rsplit(".", 1)[-1] in _CONST_BUFFERS:
            collection = "consts"
        else:
            collection = "ema"
        value = value.detach().cpu()
        array = value.float().numpy() if value.is_floating_point() else value.numpy()
        node = tree.setdefault(collection, {})
        path = torch_key_to_flax_path(key)
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = array
    return tree
