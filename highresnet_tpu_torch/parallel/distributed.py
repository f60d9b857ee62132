"""Multi-process runtime: joining the process group and the collectives.

The counterpart of ``highresnet_tpu/parallel/distributed.py``. Each process
is one JAX "host" with one device: it reads its own shard of the scene list,
runs the train step on its share of the global batch, and joins the other
processes in a few collectives. Parameters, optimizer state and BatchNorm
statistics stay identical on every process (``assert_replicated`` checks).

The environment asks for a process group, as in the JAX package:

  HRN_COORDINATOR=host:port            -> init_method tcp://host:port, with
  HRN_NUM_PROCESSES=N HRN_PROCESS_ID=i    world size N and rank i
  HRN_DISTRIBUTED=auto                 -> init_method env:// (torchrun's RANK,
                                          WORLD_SIZE, MASTER_ADDR, MASTER_PORT)

and with neither set a run is one process and nothing here communicates.
The backend is NCCL for a CUDA device and Gloo for the CPU; ``backend=``
overrides it (two ranks that share one card must use Gloo: NCCL refuses
them).

Under Gloo every collective runs on host copies of its tensors, chosen by
the backend (``_comm_device``), so one code path serves CPU tensors and
ranks that share a card; under NCCL they run on the current CUDA device.
Only ``all_reduce``, ``broadcast`` and ``all_gather`` are used, which both
backends have. Sums over ranks come out bit-identical on every rank, so the
ranks stay replicated step after step.

Each collective takes a ``group=`` (None: every rank of the run): the 2-D
layout (``parallel/mesh.py``) reduces batch statistics over its data group
and gathers view blocks over its view group (``gather_views``).
"""

from __future__ import annotations

import datetime
import hashlib
import os
from typing import Dict, Iterable

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=10)  # a rank that dies fails the others within it


def maybe_initialize(device: torch.device | str = "cpu", backend: str | None = None,
                     timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the process group when the environment asks for one.

    Safe to call more than once and in one-process runs (a no-op), and a
    no-op when the caller has already initialised the group."""
    if is_initialized():
        return
    coordinator = os.environ.get("HRN_COORDINATOR", "")
    if coordinator:
        kwargs = dict(
            init_method=f"tcp://{coordinator}",
            world_size=int(os.environ["HRN_NUM_PROCESSES"]),
            rank=int(os.environ["HRN_PROCESS_ID"]),
        )
    elif os.environ.get("HRN_DISTRIBUTED", "") == "auto":
        kwargs = dict(init_method="env://")
    else:
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, timeout=timeout, **kwargs)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index(group=None) -> int:
    """This process's rank in ``group`` (None: the whole run)."""
    return dist.get_rank(group) if is_initialized() else 0


def process_count(group=None) -> int:
    """The number of processes in ``group`` (None: the whole run)."""
    return dist.get_world_size(group) if is_initialized() else 1


def is_multihost() -> bool:
    return process_count() > 1


def _comm_device() -> torch.device:
    """Where collectives run: the host under Gloo, the current card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """A new tensor on x's device: x reduced over the ranks of ``group`` with ``op``."""
    buf = x.detach().to(_comm_device(), copy=True)
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of a group; the backward sums the ranks' output
    gradients, so each rank's input gets the gradient of the sum of every
    rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group=group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, group=ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of x over the ranks of ``group``, differentiable (see ``_AllReduceSum``)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of x over the ranks of ``group`` (no gradient)."""
    return _all_reduce(x, group=group) / process_count(group)


def all_reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max of x over the ranks of ``group`` (no gradient)."""
    return _all_reduce(x, dist.ReduceOp.MAX, group)


@torch.no_grad()
def reduce_gradients_(grads: list[torch.Tensor], group=None) -> None:
    """Replace each gradient by its mean over the ranks of ``group``: one
    all-reduce over a flat buffer of every gradient, in the order given."""
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), group=group)
    flat.div_(process_count(group))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *x.shape): the x of each of the n ranks of ``group``, stacked in
    rank order, on x's device."""
    buf = x.detach().to(_comm_device()).contiguous()
    parts = [torch.zeros_like(buf) for _ in range(process_count(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.stack(parts).to(x.device)


class _GatherViews(torch.autograd.Function):
    """Forward: every rank's view block, concatenated on the view axis in
    rank order. Backward: the gradients of the whole stack summed over the
    ranks, then this rank's block (a reduce-scatter from ``all_reduce`` and
    a slice: each rank's gradient holds only the uses its own computation
    made of the stack)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.block = (process_index(group) * x.shape[1], x.shape[1])
        parts = all_gather(x, group)  # (M, B, k, ...)
        return torch.cat(parts.unbind(0), dim=1)

    @staticmethod
    def backward(ctx, grad):
        start, k = ctx.block
        return _all_reduce(grad, group=ctx.group).narrow(1, start, k).contiguous(), None


def gather_views(x: torch.Tensor, group) -> torch.Tensor:
    """(B, M·k, ...) from each of the M ranks' (B, k, ...) blocks of the view
    group, differentiable (see ``_GatherViews``)."""
    return _GatherViews.apply(x, group)


def broadcast_string(s: str) -> str:
    """Rank 0's string on every rank (the run-dir name: each host's clock
    would mint its own)."""
    if not is_multihost():
        return s
    box = [s]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def checksum(tensors: Iterable[torch.Tensor]) -> int:
    """64 bits of a SHA-256 over the tensors' bytes, in the order given."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def assert_replicated(groups: Dict[str, Iterable[torch.Tensor]], what: str) -> None:
    """Raise unless every rank holds the same bytes in each group: one
    checksum per group, all-gathered."""
    if not is_multihost():
        return
    names = list(groups)
    local = torch.tensor([checksum(groups[n]) for n in names], dtype=torch.int64)
    sums = all_gather(local)
    differ = [n for i, n in enumerate(names) if not bool((sums[:, i] == sums[0, i]).all())]
    if differ:
        raise RuntimeError(f"the ranks hold different {', '.join(differ)} {what}")
