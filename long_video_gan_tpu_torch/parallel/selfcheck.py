"""One training step of either tiny trainer, the same function on one process
and on several: the harness that `tests/test_torch_parallel.py` (gloo on the
CPU) and `chip_smoke.py` (on the card) share, so the two hold the parallel
layer to the same cases and bars.

`tiny_step` runs one `train_step` at step 0 of the CLI's `tiny` preset at a
global batch, grad-accum 2, with R1 (and, for sres, ADA's update) due; sres
with ADA forced to p = 0.5 and the lr in-augment on. Real batches come from
numpy at the global batch, each process taking its rows (global row q on rank
q % world). `relative_errors` holds two results: each tensor to its largest
value, the parameters and G_ema to their module's largest. One process and
several sum the same terms in another order, and Adam's first step divides
each gradient element by its own size (lr * g / (|g| + 1e-8)), so a bias
element whose gradient is 1e-4 of its tensor's largest carries that float32
noise into its update about 1e4 times over; its module's scale does not.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh

SEED = 3
GLOBAL_BATCH = 4
GRAD_ACCUM = 2


def trainer(kind: str, device, global_batch: int = GLOBAL_BATCH):
    """(CLI module, config, trainer) of the `tiny` preset."""
    if kind == "lres":
        from .. import train_lres as cli
    else:
        from .. import train_sres as cli
    c = cli.build_config("", global_batch, GRAD_ACCUM, 1.0, "tiny")
    if kind == "sres":
        c["gan_kwargs"].update(augment_p_init=0.5)
    gan = cli.make_gan(c, torch.device(device))
    gan.init_state(torch.Generator().manual_seed(SEED))
    return cli, c, gan


def _batches(kind: str, c: dict, device, global_batch: int):
    rng = np.random.default_rng(SEED + 1)
    if kind == "lres":
        shapes = {None: (c["seq_length"], c["height"], c["width"])}
    else:
        t = c["seq_length"] + 2 * c["temporal_context"]
        shapes = {"lr_video": (t, c["lr_height"], c["lr_width"]),
                  "hr_video": (t, c["hr_height"], c["hr_width"])}
    while True:
        batch = {key: mesh.local_rows(torch.from_numpy(
            rng.uniform(-1, 1, (global_batch, 3, *shape)).astype(np.float32))).to(device)
                 for key, shape in shapes.items()}
        yield batch[None] if kind == "lres" else batch


def train_state(gan) -> dict[str, torch.Tensor]:
    """Copies of the trainer's state: G, D and G_ema (parameters and
    buffers: magnitude EMAs, w_avg), both Adam states and the trainer's
    `extra_state` (sres: ada_p and ADA's sign moments)."""
    out = {f"{name}.{k}": v.detach().clone() for name, m in
           (("G", gan.G), ("D", gan.D), ("G_ema", gan.G_ema)) for k, v in m.state_dict().items()}
    for name, opt in (("opt_G", gan.opt_G), ("opt_D", gan.opt_D)):
        for i, (mu, nu) in enumerate(zip(opt.mu, opt.nu)):
            out[f"{name}.mu.{i}"], out[f"{name}.nu.{i}"] = mu.clone(), nu.clone()
    for name in gan.extra_state:
        out[name] = getattr(gan, name).clone()
    return out


def param_keys(gan) -> set[str]:
    """The keys of `train_state` that are parameters of G, D or G_ema."""
    return {f"{module}.{name}" for module in ("G", "D", "G_ema")
            for name, _ in getattr(gan, "G" if module == "G_ema" else module).named_parameters()}


def tiny_step(kind: str, device="cpu", global_batch: int = GLOBAL_BATCH) -> dict:
    """One `train_step` at step 0 (G, D, R1, for sres ADA, then the G_ema
    update) on this process's rows: the train state it leaves, on the CPU,
    and the tick's statistics as `stats.<name>` (float64 means)."""
    from ..train.common import step_generator
    from ..train.stats import Collector

    cli, c, gan = trainer(kind, device, global_batch)
    collector = Collector()
    for stats in cli.train_step(gan, step_generator(SEED, 0, device), c, 0,
                                _batches(kind, c, device, global_batch)):
        collector.report(stats)
    collector.update()
    out = {k: v.cpu() for k, v in train_state(gan).items()}
    for name in collector.names():
        out[f"stats.{name}"] = torch.tensor(collector.mean(name), dtype=torch.float64)
    return out


def relative_errors(got: dict, want: dict, params: set[str]) -> dict[str, float]:
    """max |got - want| of each key over its scale: its tensor's largest
    |want|, or for a parameter its module's largest."""
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    module_scale = {}
    for key in params:
        module = key.split(".")[0]
        module_scale[module] = max(module_scale.get(module, 0.0),
                                   want[key].abs().max().item())
    errors = {}
    for key, value in want.items():
        scale = (module_scale[key.split(".")[0]] if key in params
                 else value.double().abs().max().item())
        err = (got[key].double() - value.double()).abs().max().item()
        errors[key] = err / max(scale, 1e-30)
    return errors
