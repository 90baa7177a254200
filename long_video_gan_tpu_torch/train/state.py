"""Train state to and from `.lvg` train checkpoints, for both trainers.

The tree is the one the JAX package writes: its `GANState` under
`flax.serialization.to_state_dict`, with `step`, `G`, `G_ema` and `D` as flax
variable trees and `opt_G` / `opt_D` as optax `inject_hyperparams(adam)` lays
its state out:

    {"count", "hyperparams": {"eps_root", "learning_rate"},
     "hyperparams_states": {}, "inner_state": {"0": {"count", "mu", "nu"}, "1": {}}}

with `mu` and `nu` trees shaped as the module's "params", and after them the
tensors the trainer names in its `extra_state` (the sres trainer's `ada_p`
and `sign_real_moments`). So a run moves between the JAX package
(`io.checkpoint.load_checkpoint(path, target=state)`) and the port, either
way; the header holds {"step": step}.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..io.checkpoint import load_checkpoint, save_checkpoint
from ..io.convert_torch import (flatten_variables, load_jax_variables, module_to_variables,
                                torch_key_to_flax_path)
from ..parallel import mesh
from .common import Adam


def _nest(named: dict[str, torch.Tensor]) -> dict:
    """{torch key: tensor} -> a flax tree of float32 numpy arrays."""
    tree: dict = {}
    for key, value in named.items():
        path = torch_key_to_flax_path(key)
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = value.detach().float().cpu().numpy()
    return tree


def adam_to_tree(opt: Adam, module: torch.nn.Module) -> dict:
    """`opt` (over `module.parameters()`) as optax's state tree."""
    names = [name for name, _ in module.named_parameters()]
    assert len(names) == len(opt.params)
    count = np.asarray(opt.count, np.int32)
    return {
        "count": count,
        "hyperparams": {"eps_root": np.asarray(0.0, np.float32),
                        "learning_rate": np.asarray(opt.lrate, np.float32)},
        "hyperparams_states": {},
        "inner_state": {"0": {"count": count, "mu": _nest(dict(zip(names, opt.mu))),
                              "nu": _nest(dict(zip(names, opt.nu)))},
                        "1": {}},
    }


def adam_from_tree(opt: Adam, module: torch.nn.Module, tree: dict) -> None:
    """Load optax's state tree into `opt` (over `module.parameters()`)."""
    params = dict(module.named_parameters())
    inner = tree["inner_state"]["0"]
    moments = {}
    for which in ("mu", "nu"):
        arrays = flatten_variables({which: inner[which]})
        if set(arrays) != set(params):
            raise KeyError(f"{which} does not match the module's parameters: "
                           f"{sorted(set(arrays) ^ set(params))[:10]}")
        moments[which] = [torch.from_numpy(np.array(arrays[name], np.float32)).to(p.device)
                          for name, p in params.items()]
        for m, (name, p) in zip(moments[which], params.items()):
            if m.shape != p.shape:
                raise ValueError(f"{which} of {name}: {tuple(m.shape)} vs {tuple(p.shape)}")
    count = int(np.asarray(inner["count"]))
    if int(np.asarray(tree["count"])) != count or float(np.asarray(
            tree["hyperparams"]["eps_root"])) != 0.0:
        raise ValueError("an optimizer state that optax's adam with eps_root 0 does not make")
    opt.mu, opt.nu = moments["mu"], moments["nu"]
    opt.count = count
    opt.lrate = float(np.asarray(tree["hyperparams"]["learning_rate"]))


def gan_to_tree(gan) -> dict:
    """The trainer's whole state (`LowResVideoGAN` or `SuperResVideoGAN`) as
    the JAX package's `GANState` tree."""
    tree = {"step": np.asarray(gan.step, np.int32),
            "G": module_to_variables(gan.G), "G_ema": module_to_variables(gan.G_ema),
            "D": module_to_variables(gan.D),
            "opt_G": adam_to_tree(gan.opt_G, gan.G), "opt_D": adam_to_tree(gan.opt_D, gan.D)}
    for name in gan.extra_state:
        tree[name] = getattr(gan, name).detach().float().cpu().numpy()
    return tree


def gan_from_tree(gan, tree: dict) -> None:
    """Load a `GANState` tree (`gan_to_tree`'s, or the JAX package's) into
    the trainer, in place."""
    for name in ("G", "G_ema", "D"):
        load_jax_variables(getattr(gan, name), tree[name])
    adam_from_tree(gan.opt_G, gan.G, tree["opt_G"])
    adam_from_tree(gan.opt_D, gan.D, tree["opt_D"])
    gan.step = int(np.asarray(tree["step"]))
    for name in gan.extra_state:
        setattr(gan, name, torch.tensor(np.asarray(tree[name], np.float32), device=gan.device))


def save_train_checkpoint(path: str, gan, config: Optional[dict] = None) -> None:
    """Write the trainer's state with the header {"step": gan.step, **config}."""
    save_checkpoint(path, gan_to_tree(gan), dict(step=gan.step, **(config or {})))


def load_train_checkpoint(path: str, gan) -> dict[str, Any]:
    """Load a train checkpoint into the trainer; returns its header. The
    trainer's step becomes the header's "step" where it has one."""
    tree, config = load_checkpoint(path)
    gan_from_tree(gan, tree)
    gan.step = int(config.get("step", gan.step))
    return config


def replicate_train_state(gan) -> None:
    """Rank 0's train state on every process: G, D, G_ema, both Adam states
    and the trainer's `extra_state` (the JAX CLIs' `replicate(state, mesh)`)."""
    mesh.replicate(gan.G, gan.D, gan.G_ema, gan.opt_G.mu, gan.opt_G.nu, gan.opt_D.mu,
                   gan.opt_D.nu, *(getattr(gan, name) for name in gan.extra_state))
