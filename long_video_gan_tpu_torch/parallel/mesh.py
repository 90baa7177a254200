"""The collectives that the JAX package's mesh gives implicitly, written out.

Counterpart of `long_video_gan_tpu/parallel/mesh.py`. There the batch axis is
sharded over the mesh, parameters are replicated, and every reduction over the
global batch (gradient means, magnitude EMAs, w_avg, ADA's sign statistics,
the stats) is an XLA-inserted collective inside the compiled step. Here each
process holds its share of the batch, and the trainers call these helpers at
each of those places.

Every helper is a no-op without a process group, so a single process computes
what it always did. With a group (NCCL on CUDA, gloo on the CPU; see
`multihost`) the collectives run, at world size 1 too.

Batch layout: global row q of a batch lives on rank q % world, as row
q // world there. The loader shards so (`order[shard_id::num_shards]`, as
PyTorch's DistributedSampler does), and a micro-batch split of a rank's rows
keeps it: micro-batch i of the global batch is micro-batch i of every rank,
interleaved. Random draws (`global_draw`) and the gathered batch
(`all_gather_batch`) follow the same layout, so N processes at a global batch
B compute what one process computes at batch B, up to the order of summation.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from .multihost import local_batch_size, rank, world_size


def distributed() -> bool:
    """True when a process group is initialized: the collectives run."""
    return dist.is_available() and dist.is_initialized()


def comm_device() -> torch.device:
    """Where a host-side value goes for a collective: this process's GPU
    under NCCL, the CPU under gloo."""
    if distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_batch(total_batch: int) -> dict:
    """The loader's sharding of a global batch of `total_batch`: this
    process's `batch_size`, `shard_id` and `num_shards` for
    `data.loader.get_infinite_data_iter`."""
    return dict(batch_size=local_batch_size(total_batch), shard_id=rank(),
                num_shards=world_size())


def _tensors(items) -> list[torch.Tensor]:
    out = []
    for item in items:
        if isinstance(item, nn.Module):
            out.extend(item.state_dict(keep_vars=True).values())
        elif isinstance(item, torch.Tensor):
            out.append(item)
        else:
            out.extend(_tensors(item))
    return out


@torch.no_grad()
def replicate(*items) -> None:
    """Broadcast from rank 0, in place: the parameters and buffers of each
    module, and each tensor (or list of tensors), in `items`."""
    if not distributed():
        return
    tensors = _tensors(items)
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for group in by_kind.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src=0)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.detach().copy_(part.view_as(t))


@torch.no_grad()
def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Sum `tensors` (one dtype, one device) over the processes, in place,
    through one flat buffer."""
    if not distributed() or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
    return tensors


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Average `tensors` over the processes, in place, through one flat
    buffer: the reference's flat-gradient all_reduce, then a division by the
    world size."""
    if not distributed() or not tensors:
        return tensors
    all_reduce_sum_(tensors)
    torch._foreach_div_(list(tensors), float(world_size()))
    return tensors


def mean_over_processes(x: torch.Tensor) -> torch.Tensor:
    """A detached copy of `x` averaged over the processes (`x` itself
    without a process group)."""
    if not distributed():
        return x
    return all_reduce_mean_([x.detach().clone()])[0]


class _AllGatherBatch(torch.autograd.Function):
    """[n, ...] per process -> [n * world, ...], global row j * world + r
    from row j of rank r. Its gradient is `_ReduceSliceBatch`."""

    @staticmethod
    def forward(ctx, x):
        w = world_size()
        parts = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(parts, x.contiguous())
        return torch.stack(parts, dim=1).reshape(x.shape[0] * w, *x.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        return _ReduceSliceBatch.apply(grad)


class _ReduceSliceBatch(torch.autograd.Function):
    """[n * world, ...] per process -> the sum over processes, rows of this
    rank. The adjoint of `_AllGatherBatch`, whose gradient it is in turn, so
    a second-order gradient (R1) goes through both."""

    @staticmethod
    def forward(ctx, grad):
        total = grad.contiguous().clone()
        dist.all_reduce(total)
        return total[rank()::world_size()].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _AllGatherBatch.apply(grad)


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch from every process's rows, differentiably: its
    backward is an all_reduce and a slice (gloo has no reduce_scatter).
    Identity at world size 1."""
    if world_size() == 1:
        return x
    return _AllGatherBatch.apply(x)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This process's rows of a global batch (global row q on rank q % world)."""
    w = world_size()
    return x if w == 1 else x[rank()::w]


def global_draw(draw: Callable[[int], torch.Tensor], n: int) -> torch.Tensor:
    """A batch-leading random tensor for `n` local rows: `draw(n * world)`,
    taken at the global batch size from the generator every process holds
    alike, and this process's rows of it. A JAX run draws at the global
    shape from one key, so its result does not depend on the device count;
    this keeps that. At world size 1 it is `draw(n)`."""
    w = world_size()
    if w == 1:
        return draw(n)
    return draw(n * w)[rank()::w].contiguous()


def barrier() -> None:
    if distributed():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's `obj` on every process."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
