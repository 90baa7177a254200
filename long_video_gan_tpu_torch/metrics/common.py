"""What the three detector modules share: bilinear resizing with
`jax.image.resize`'s function, and loading a detector file's weights.

The JAX package's detectors resize with `jax.image.resize(...,
method="bilinear")`, which antialiases: when it shrinks an axis, it widens
its triangle kernel by the inverse scale (a low-pass filter), which
`F.interpolate` without `antialias` does not do. Here each resized axis is
the JAX package's weight matrix (`jax._src.image.scale.compute_weight_mat`,
the triangle kernel at half-pixel sample positions, renormalized, in
float32), applied as a matrix product.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch import nn


@functools.lru_cache(maxsize=32)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 weights taking an axis of `in_size` samples
    to `out_size` (translation 0, antialiased triangle kernel)."""
    inv_scale = np.float32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - \
        np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)
    weights.flags.writeable = False
    return weights


def resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Resize the last two axes of float `x` to `size` (height, width) as
    `jax.image.resize(..., method="bilinear")` does; an axis whose size does
    not change is left as it is."""
    height, width = size
    if x.shape[-1] != width:
        x = x @ torch.tensor(resize_weights(x.shape[-1], width), dtype=x.dtype, device=x.device)
    if x.shape[-2] != height:
        w = torch.tensor(resize_weights(x.shape[-2], height), dtype=x.dtype, device=x.device)
        x = w.transpose(0, 1) @ x
    return x


# ---------------------------------------------------------------------------
# Detector files and their weights.


def load_detector_file(path: str) -> nn.Module:
    """A detector file as a module on the CPU: a `.pkl` by `pickle.load`
    (unpickling can run code: load only files you trust), anything else by
    `torch.jit.load`."""
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as fp:
            return pickle.load(fp)
    return torch.jit.load(path, map_location="cpu")


def as_tensors(state_dict: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A state_dict of torch tensors or numpy arrays as CPU tensors."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in state_dict.items()}


def weight_entries(module: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """The module's state_dict entries a detector file supplies, in
    registration order (batch norm's step counters are not among them)."""
    return [(k, v) for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")]


def by_order(module: nn.Module, items: dict[str, torch.Tensor], family: str
             ) -> dict[str, torch.Tensor]:
    """Order+shape conversion for exports with unfamiliar key names: a
    state_dict keeps module registration order, and the topology is fixed,
    so each of the module's entries takes the file's next tensor of its
    shape."""
    tensors = [v for v in items.values() if v.ndim > 0]
    out, idx = {}, 0
    for key, want in weight_entries(module):
        while idx < len(tensors) and tensors[idx].shape != want.shape:
            idx += 1
        if idx >= len(tensors):
            raise ValueError(f"order-based {family} conversion failed at {key}")
        out[key] = tensors[idx]
        idx += 1
    return out


def load_weights(module: nn.Module, state_dict: dict[str, torch.Tensor]) -> nn.Module:
    """Load converted weights into `module`: every tensor it needs and no
    other, each of its shape (batch norm's step counters excepted)."""
    want = dict(weight_entries(module))
    if set(state_dict) != set(want):
        missing, extra = sorted(set(want) - set(state_dict)), sorted(set(state_dict) - set(want))
        raise ValueError(f"converted weights do not fit: missing {missing[:3]}, extra {extra[:3]}")
    module.load_state_dict(state_dict, strict=False)
    return module
