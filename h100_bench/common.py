"""What every driver shares: the run's settings, seeds, and the weights.

Weights are the benchmark's: `draw_state` takes the reference module's
state dict (its constant biases and EMAs), draws every parameter that the
initializers draw (`init_stds`) in one call on the card's generator, and
gives the same dict to the program and to the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch


@dataclass
class Run:
    """One run of one cell: its files' contents and the command line's
    settings. `alter` is applied to each answer where the program hands it
    over (the identity; tests plant faults there)."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: bool = False
    alter: Callable[[Any], Any] = field(default=lambda x: x)


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream named `tag` of run seed `seed` (any
    whole number, 32 bits or more)."""
    words = [ord(c) for c in tag]
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *words]).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


def seeded(seed: int, tag: str, device) -> torch.Generator:
    """A torch.Generator on `device` for the stream `tag` of the run."""
    return torch.Generator(device=device).manual_seed(subseed(seed, tag) % 2 ** 63)


def init_stds(module: torch.nn.Module) -> dict[str, float]:
    """{state-dict key: std} of every parameter the initializers draw
    (modules of the reference declare theirs in `init_stds()`)."""
    out = {}
    for name, sub in module.named_modules():
        if hasattr(sub, "init_stds"):
            for pname, std in sub.init_stds().items():
                out[f"{name}.{pname}" if name else pname] = std
    return out


def draw_state(ref: torch.nn.Module, seed: int, device, tag: str = "weights"
               ) -> dict[str, torch.Tensor]:
    """The state dict of `ref` with every drawn parameter N(0, std^2), drawn
    in one call on `device` from the run's seed, the rest as built."""
    state = {k: v.to(device) for k, v in ref.state_dict().items()}
    stds = init_stds(ref)
    keys = sorted(stds)
    total = sum(state[k].numel() for k in keys)
    flat = torch.randn(total, generator=seeded(seed, tag, device), device=device)
    offset = 0
    for k in keys:
        n = state[k].numel()
        state[k] = flat[offset:offset + n].view(state[k].shape) * stds[k]
        offset += n
    return state


def finite(x: float) -> float:
    """`x`, or infinity where it is not a number: a compared number that
    is NaN fails its limit."""
    return x if math.isfinite(x) else math.inf


def release(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)

