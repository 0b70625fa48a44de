"""Process groups for multi-card runs: one process a card, launched by
``torchrun`` (``python -m torch.distributed.run``).

Counterpart of ``dinomc_tpu/parallel/distributed.py``; parity target the
reference's NCCL bootstrap and rank helpers (``init_distributed_mode``,
``get_world_size`` ... ``setup_for_distributed``, ``utils/utils.py:446-516``).
Where JAX runs one SPMD program over a mesh, the port runs one process a card:
``init_distributed_mode`` reads torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` and brings up NCCL for a
card (``cuda:LOCAL_RANK``) or gloo for the CPU. Without those variables a
process runs alone, with no group and no collective.

Also here: the collectives the trainers differentiate through
(``all_reduce_sum``: backward all-reduces the gradient; ``all_gather``:
backward reduce-scatters it), and ``batch_shard``, the context a distributed
step runs in. Inside it, the three BatchNorm sites take their moments over
the ranks that split the batch (``batch_mean``: SyncBN), and DropPath draws
the global batch's keep-decisions and keeps this rank's rows
(``global_bernoulli``), so a run at world W computes what one process
computes on the same global batch.
"""

from __future__ import annotations

import builtins
import contextlib
import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_ORIGINAL_PRINT = builtins.print


def init_distributed_mode(device: str = "cuda", init_method: str = "env://",
                          timeout_s: float = 600.0) -> bool:
    """Join the process group that torchrun's environment describes; return
    whether a group is up. A no-op (False) when ``RANK`` / ``WORLD_SIZE``
    are not set, or when a group is already up (True). ``device`` 'cuda'
    (or 'cuda:N') takes NCCL on ``cuda:LOCAL_RANK``; 'cpu' takes gloo."""
    if dist.is_available() and dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(local_rank())
    dist.init_process_group(
        "nccl" if on_card else "gloo", init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def process_device(device: str) -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` for a bare 'cuda'
    while a group is up, else ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and is_initialized():
        return torch.device("cuda", local_rank())
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if is_initialized() else 1


def get_rank(group=None) -> int:
    return dist.get_rank(group) if is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def save_on_master(save_fn, *args, **kwargs) -> None:
    """Run a host-side save only on rank 0 (``utils/utils.py:462-464``)."""
    if is_main_process():
        save_fn(*args, **kwargs)


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def comm_device() -> torch.device:
    """Where host values go for a collective: the current card under NCCL,
    the CPU under gloo."""
    if is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_dict(input_dict: dict, average: bool = True) -> dict:
    """Sum (or average) a dict of host scalars across processes (reference
    ``reduce_dict``, ``utils/utils.py:301-325``). Alone: a copy."""
    if get_world_size() < 2:
        return dict(input_dict)
    keys = sorted(input_dict)
    vals = torch.tensor([float(input_dict[k]) for k in keys], dtype=torch.float64,
                        device=comm_device())
    dist.all_reduce(vals)
    if average:
        vals /= get_world_size()
    return {k: float(v) for k, v in zip(keys, vals.tolist())}


def setup_for_distributed(is_master: Optional[bool] = None) -> None:
    """Gate ``print`` to the master process unless ``force=True`` is passed
    (``utils/utils.py:467-479``); ``destroy`` restores it."""
    master = is_main_process() if is_master is None else is_master

    def print_gated(*args, **kwargs):
        force = kwargs.pop("force", False)
        if master or force:
            _ORIGINAL_PRINT(*args, **kwargs)

    builtins.print = print_gated


def destroy(keep_group: bool = False) -> None:
    """Restore ``print`` and tear the group down (unless ``keep_group``)."""
    builtins.print = _ORIGINAL_PRINT
    if is_initialized() and not keep_group:
        dist.destroy_process_group()


# ---- collectives ------------------------------------------------------------


def all_reduce_(x: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place, no autograd."""
    dist.all_reduce(x, op=op, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group; its backward sums the gradients over the group."""
    return _AllReduceSum.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        parts = [p.contiguous() for p in g.chunk(dist.get_world_size(ctx.group), dim=ctx.dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out, None, None


def all_gather(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order; its
    backward reduce-scatters (sums) the gradient."""
    return _AllGather.apply(x, dim, group)


@torch.no_grad()
def gather_into(full: torch.Tensor, part: torch.Tensor, dim: int, group=None) -> None:
    """Write the group's ``part``s, in rank order along ``dim``, into ``full``."""
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, part.contiguous(), group=group)
    full.copy_(torch.cat(parts, dim=dim))


# ---- the batch a distributed step splits ------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """The ranks that split a step's batch: their group (None: every
    rank), their number, this rank's place among them (its rows are the
    ``index``-th block of each crop's rows), and its rows a crop."""

    group: object
    size: int
    index: int
    rows: int


_SHARD: Optional[BatchShard] = None


@contextlib.contextmanager
def batch_shard(shard: Optional[BatchShard]):
    """Run the block as one rank's share of a global batch (None: alone)."""
    global _SHARD
    prev, _SHARD = _SHARD, shard
    try:
        yield
    finally:
        _SHARD = prev


def batch_mean(local_mean: torch.Tensor) -> torch.Tensor:
    """SyncBN: a per-rank mean over equal row counts -> the global batch's
    mean, differentiably; unchanged outside ``batch_shard``."""
    if _SHARD is None:
        return local_mean
    return all_reduce_sum(local_mean, _SHARD.group) / _SHARD.size


def batch_count() -> int:
    """The number of ranks a BatchNorm's rows span (1 outside ``batch_shard``)."""
    return 1 if _SHARD is None else _SHARD.size


def global_bernoulli(p: torch.Tensor, generator: Optional[torch.Generator],
                     dim: int) -> torch.Tensor:
    """``torch.bernoulli(p)`` as the global batch draws it, this rank's rows
    kept. ``p``'s ``dim`` holds this rank's k crops of ``rows`` samples each,
    crop-major; the draw covers k crops of ``size * rows``, the shape one
    process draws for the global batch, and keeps block ``index`` of each."""
    if _SHARD is None:
        return torch.bernoulli(p, generator=generator)
    s = _SHARD
    n = p.shape[dim]
    k = n // s.rows
    shape = list(p.shape)
    shape[dim] = n * s.size
    draw = torch.bernoulli(p.narrow(dim, 0, 1).expand(shape), generator=generator)
    draw = draw.reshape(shape[:dim] + [k, s.size, s.rows] + shape[dim + 1:])
    return draw.select(dim + 1, s.index).reshape(p.shape)
