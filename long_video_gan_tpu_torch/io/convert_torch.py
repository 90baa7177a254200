"""Load the JAX package's variable trees into the port's modules.

Counterpart of `long_video_gan_tpu/io/convert_torch.py`, in the other
direction: a flax variable tree ({"params", "ema", "consts"} of arrays, as a
`.lvg` body or `jax.device_get` gives it) becomes the module's state_dict. Each
leaf's key is `flax_path_to_torch_key` of its path without the collection.
The load is strict both ways: a key missing on either side, or a shape
mismatch, raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from long_video_gan_tpu.io.convert_torch import flax_path_to_torch_key


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
