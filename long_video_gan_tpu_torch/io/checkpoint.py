"""Read `.lvg` generator checkpoints written by the JAX package.

Counterpart of `long_video_gan_tpu/io/checkpoint.py`. The format: the magic
`LVGTPU1\\0`, a little-endian u64 header length, a JSON header
({"kind", "kwargs", ...}), then a flax msgpack body holding the variable tree
({"params", "ema", "consts"} of arrays). Reading never executes checkpoint
content and needs neither flax nor msgpack.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Union

import torch

from .convert_torch import load_jax_variables
from .msgpack_decode import unpackb

_MAGIC = b"LVGTPU1\0"


def load_checkpoint(path: str) -> tuple[Any, dict]:
    """Read (variable tree of numpy arrays, config)."""
    with open(path, "rb") as fp:
        if fp.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"not a long_video_gan_tpu checkpoint: {path}")
        (header_len,) = struct.unpack("<Q", fp.read(8))
        config = json.loads(fp.read(header_len).decode("utf-8"))
        blob = fp.read()
    return unpackb(blob), config


def load_generator(path: str, device: Union[str, torch.device, None] = None):
    """Rebuild (module in eval mode with the checkpoint's weights, config):
    the port's module of the config's "kind", built from its "kwargs"."""
    tree, config = load_checkpoint(path)
    kind = config.get("kind")
    if kind == "generator_lres":
        from ..models.generator_lres import VideoGenerator
    elif kind == "generator_sres":
        from ..models.generator_sres import VideoGenerator
    else:
        raise ValueError(f"unknown checkpoint kind: {kind!r}")
    module = VideoGenerator(**config.get("kwargs", {}), device=device)
    load_jax_variables(module, tree)
    return module.eval().requires_grad_(False), config
