"""Read and write `.lvg` checkpoints in the JAX package's format.

Counterpart of `long_video_gan_tpu/io/checkpoint.py`. The format: the magic
`LVGTPU1\\0`, a little-endian u64 header length, a JSON header
({"kind", "kwargs", ...}), then a flax msgpack body holding a variable tree
({"params", "ema", "consts"} of arrays). Reading never executes checkpoint
content; neither reading nor writing needs flax or msgpack, and a generator
that the port writes loads in the JAX package's `load_generator`.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Optional, Union

import torch

from .convert_torch import load_jax_variables, module_to_variables
from .msgpack_decode import unpackb
from .msgpack_encode import packb

_MAGIC = b"LVGTPU1\0"


def save_checkpoint(path: str, tree: Any, config: Optional[dict] = None) -> None:
    """Write {config, tree of numpy arrays} to `path` atomically."""
    blob = packb(tree)
    header = json.dumps(config or {}).encode("utf-8")
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fp:
        fp.write(_MAGIC)
        fp.write(struct.pack("<Q", len(header)))
        fp.write(header)
        fp.write(blob)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> tuple[Any, dict]:
    """Read (variable tree of numpy arrays, config)."""
    with open(path, "rb") as fp:
        if fp.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"not a long_video_gan_tpu checkpoint: {path}")
        (header_len,) = struct.unpack("<Q", fp.read(8))
        config = json.loads(fp.read(header_len).decode("utf-8"))
        blob = fp.read()
    return unpackb(blob), config


def save_generator(path: str, module: torch.nn.Module, config: dict) -> None:
    """Save a generator (G_ema) checkpoint: `config` names the module kind
    and its constructor kwargs, so `load_generator` (here or in the JAX
    package) can rebuild it."""
    save_checkpoint(path, module_to_variables(module), config)


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
