"""Multi-process initialization: one process per GPU over torch.distributed.

Counterpart of `long_video_gan_tpu/parallel/multihost.py`. The JAX package
runs one process per host and lets XLA insert every collective; the port runs
one process per GPU, and `parallel.mesh` writes the collectives out.

Launch recipes (every process must pass the same `--seed`):

    torchrun --nproc_per_node=N -m long_video_gan_tpu_torch.train_lres \\
        --dataset=... --batch=64 --seed=S

    LVG_COORDINATOR=host0:1234 LVG_NUM_PROCESSES=N LVG_PROCESS_ID=$i \\
        python -m long_video_gan_tpu_torch.train_lres --dataset=... --seed=S

torchrun's `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` and
`MASTER_PORT` come first; the JAX package's `LVG_*` variables are read when
torchrun's are absent, so one launch script serves both packages. Without
either the run is a single process and nothing is initialized.

Each process drives one GPU: `cuda:LOCAL_RANK`, or under the `LVG_*` form the
one id in `LVG_LOCAL_DEVICE_IDS`, else the rank modulo the visible GPUs. The
backend is NCCL on CUDA and gloo on the CPU.

Per-process responsibilities once initialized:
  * data: each process loads total_batch // world_size samples of every
    global batch (`mesh.shard_batch`);
  * filesystem: only rank 0 writes checkpoints, stats, samples and metrics
    (the train CLIs gate on `is_main_process()`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# Rank 0 scores every G_ema checkpoint while the other ranks wait at a
# barrier, so a collective must be allowed to wait that long. The longest
# protocol, fvd2048_128f, generates 2,048 clips of 128 frames at 0.57 s per
# clip on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5): 2,048 x 0.57 s
# = 19.5 min. Two hours covers it six times over: several metrics at one
# checkpoint, or a slower card.
TIMEOUT = datetime.timedelta(hours=2)

_local_device: Optional[torch.device] = None


def _launch_from_env() -> Optional[dict]:
    """The rendezvous the environment describes: init_method, rank,
    world_size and local_rank, or None for a single process."""
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT", "29500")
        return dict(init_method=f"tcp://{addr}:{port}", rank=int(env["RANK"]),
                    world_size=int(env["WORLD_SIZE"]),
                    local_rank=int(env.get("LOCAL_RANK", "0")))
    coordinator = env.get("LVG_COORDINATOR")
    if not coordinator:
        return None
    if coordinator == "auto":
        raise RuntimeError("LVG_COORDINATOR=auto is the JAX package's TPU-pod topology "
                           "auto-detection, which has no GPU counterpart: give "
                           "LVG_COORDINATOR=host:port, LVG_NUM_PROCESSES and LVG_PROCESS_ID, "
                           "or launch with torchrun")
    rank = int(env.get("LVG_PROCESS_ID", "0"))
    world = int(env.get("LVG_NUM_PROCESSES", "1"))
    if "LVG_LOCAL_DEVICE_IDS" in env:
        ids = [int(x) for x in env["LVG_LOCAL_DEVICE_IDS"].split(",")]
        if len(ids) != 1:
            raise ValueError(f"LVG_LOCAL_DEVICE_IDS={env['LVG_LOCAL_DEVICE_IDS']}: a process "
                             f"of the port drives one GPU, so give one id")
        local_rank = ids[0]
    elif "LOCAL_RANK" in env:
        local_rank = int(env["LOCAL_RANK"])
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 1
        local_rank = rank % max(count, 1)
    return dict(init_method=f"tcp://{coordinator}", rank=rank, world_size=world,
                local_rank=local_rank)


def maybe_initialize_distributed(device="cuda") -> bool:
    """Env-gated `init_process_group`. Returns True if several processes
    (or a process group that was already there).

    `device` is the CLI's device: NCCL and `cuda:<local rank>` for CUDA,
    gloo for the CPU. Idempotent: an initialized process group is left as it
    is."""
    global _local_device
    if dist.is_initialized():
        return True
    launch = _launch_from_env()
    if launch is None:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        _local_device = torch.device("cuda", launch["local_rank"])
        torch.cuda.set_device(_local_device)
        backend = "nccl"
    else:
        _local_device = torch.device("cpu")
        backend = "gloo"
    dist.init_process_group(backend, init_method=launch["init_method"], rank=launch["rank"],
                            world_size=launch["world_size"], timeout=TIMEOUT)
    return True


def local_device(device) -> torch.device:
    """The device this process trains on: `device`, with a CUDA device taken
    as this process's GPU once initialized."""
    device = torch.device(device)
    if device.type == "cuda" and _local_device is not None and _local_device.type == "cuda":
        return _local_device
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def local_batch_size(total_batch: int) -> int:
    """Per-process share of the global batch (reference train_lres.py:65-67)."""
    n = world_size()
    assert total_batch % n == 0, (
        f"total batch {total_batch} not divisible by {n} hosts")
    return total_batch // n
