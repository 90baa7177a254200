"""Shared training machinery: the optimizer, gradient hygiene and EMA.

Benchmark reference: a frozen copy of `long_video_gan_tpu_torch/train/common.py`, plain
PyTorch on one process (the collectives are identities), importing only
`h100_bench.reference`; initializers declare `init_stds()` in place of
drawing, since the benchmark draws the weights.

Counterpart of `long_video_gan_tpu/train/common.py`.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn



class Adam:
    """Adam(b1=0, b2, eps=1e-8) over a list of parameters, with the learning
    rate given at each step: `optax.adam` under `inject_hyperparams`, as the
    JAX package's `make_adam` builds it. With b1 = 0 the first moment is the
    gradient itself: `mu` holds the last step's gradients, which the update
    never reads, so that a train checkpoint carries optax's whole state.
    `lrate` is the last learning rate given, in float32 (optax's injected
    hyperparameter)."""

    def __init__(self, params: Iterable[torch.Tensor], beta2: float, eps: float = 1e-8,
                 lrate: float = 0.0):
        self.params = list(params)
        self.beta2, self.eps = float(beta2), float(eps)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.lrate = float(np.float32(lrate))

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lrate: float) -> None:
        """params -= lrate * g / (sqrt(nu / (1 - b2**count)) + eps)."""
        self.count += 1
        self.lrate = float(np.float32(lrate))
        self.mu = list(grads)
        b2 = self.beta2
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        correction = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** self.count)
        denom = torch._foreach_div(self.nu, correction)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, grads, denom, value=-float(lrate))


def micro_loss(remat: bool, fn, generator: Optional[torch.Generator], *args):
    """`fn(generator, *args)`, a micro-batch loss (the program's recompute
    option is not part of the benchmark's configurations)."""
    assert not remat
    return fn(generator, *args)


def warmup_lrate(base: float, step: int, warmup_steps: int) -> float:
    """lr * min((step+1)/(warmup+1), 1)."""
    return base * min((step + 1.0) / (warmup_steps + 1.0), 1.0)


def scrub_grads(grads: Sequence[torch.Tensor], gain: Optional[float] = None) -> list[torch.Tensor]:
    """Optional gain, then nan -> 0 and +-inf -> +-1e5, as the JAX package
    (and the reference's sync_grads) post-process gradients."""
    out = []
    for g in grads:
        if gain is not None:
            g = g * gain
        out.append(torch.nan_to_num(g, nan=0.0, posinf=1e5, neginf=-1e5))
    return out


def collect_grads(params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each parameter's accumulated .grad, zeros where none arrived."""
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


def ema_beta_schedule(step: int, ema_beta: float, warmup_steps: int) -> float:
    """Warmup-ramped EMA decay: min(ema_beta ** ((warmup+1)/(step+1)), ema_beta),
    in float32 as the JAX package computes it (at step 0 the float32 rounding
    of 0.99985, raised to the 25001st power, moves the result by 6e-4)."""
    exponent = np.float32(warmup_steps + 1.0) / np.float32(step + 1.0)
    return float(min(np.float32(ema_beta) ** exponent, np.float32(ema_beta)))


@torch.no_grad()
def lerp_trees(target: nn.Module, source: nn.Module, weight: float) -> None:
    """target += (source - target) * weight, in place over the parameters
    AND persistent buffers (magnitude EMAs, w_avg) of two modules of one
    architecture."""
    tgt = target.state_dict()
    src = source.state_dict()
    keys = [k for k, v in tgt.items() if v.is_floating_point()]
    t = [tgt[k] for k in keys]
    diff = torch._foreach_sub([src[k].to(tgt[k].dtype) for k in keys], t)
    torch._foreach_mul_(diff, float(weight))
    torch._foreach_add_(t, diff)


def moments(x: torch.Tensor) -> torch.Tensor:
    """[count, sum, sum of squares] of all elements, as float32."""
    x = x.detach().float()
    return torch.stack([torch.tensor(float(x.numel()), device=x.device), x.sum(),
                        x.square().sum()])


def scalar_moments(value) -> torch.Tensor:
    v = torch.as_tensor(value, dtype=torch.float32).detach()
    return torch.stack([torch.ones_like(v), v, v.square()])


def loss_moments(loss: torch.Tensor) -> torch.Tensor:
    return scalar_moments(loss)
