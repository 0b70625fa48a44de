"""The process mesh and the placement of a DINO train state on it.

Counterpart of ``dinomc_tpu/core/mesh.py``. JAX lays its devices out as a
``(data, seq, model)`` mesh and runs one SPMD program over it; the port runs
one process a card and lays the ``WORLD_SIZE`` ranks out the same way, with
``model`` varying fastest, then ``seq`` (rank = (d * seq + s) * model + m, the
JAX reshape's order). ``make_mesh`` builds, for each axis, the process group
of the ranks that differ only along it: the whole group where the axis spans
every rank (at world size 1 too, so a one-rank group still runs its
collectives), none where it has length one of several ranks (a collective
over it is the identity, and is skipped).

  * ``data``: the batch. A DINO step splits its batch over data *and* model
    (``batch_sharding``'s ``P((data, model))``), so the backbone stays
    data-parallel on the model-axis ranks too; under ``fsdp`` the sizeable
    parameters' optimizer moments are split over data (``fsdp_spec``).
  * ``model``: tensor parallelism for the DINO head's weight-normed last
    layer: ``head.last_layer.weight_v`` (out_dim, bottleneck) and
    ``weight_g`` (out_dim, 1) split on out_dim, the centre the same way
    (``dino_placements``). The port keeps the reference's ``.pth`` names,
    so the split axis is dim 0 of ``weight_v``, not JAX's ``v`` dim 1.
  * ``seq``: the ViT token axis for the segmentation backbone
    (``models/vit.vit_forward_sp``, ring attention).

A placement is (axis, dim): the tensor's ``dim`` is split into equal blocks
over ``axis``, block i on the rank at coordinate i; None keeps it whole.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from dinomc_tpu_torch.parallel import distributed as pd

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)
FSDP_MIN_SIZE = 2**14  # tensors smaller than this stay whole

Placement = Optional[Tuple[str, int]]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the ``(data, seq, model)`` layout: the axis
    sizes, its coordinates and, per axis, the group of the ranks that differ
    only along it (absent for an axis of length one among several ranks).
    ``active``: a process group is up."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    active: bool

    @property
    def world(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """The axis's process group, or None where it holds this rank alone."""
        return self.groups.get(axis)

    def reduce_(self, x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """All-reduce ``x`` in place over ``axis`` (skipped where it holds
        this rank alone); returns ``x``."""
        group = self.group(axis)
        if group is not None:
            dist.all_reduce(x, op=op, group=group)
        return x

    def batch_shard(self, rows: int) -> Optional[pd.BatchShard]:
        """The DINO step's batch split, over data and model (seq is 1
        there): this rank's block is its rank."""
        if not self.active:
            return None
        assert self.size(SEQ_AXIS) == 1, "a DINO step runs at seq 1"
        return pd.BatchShard(dist.group.WORLD, self.world, pd.get_rank(), rows)


def make_mesh(data: Optional[int] = None, seq: int = 1, model: int = 1) -> Mesh:
    """The ``(data, seq, model)`` layout of the process group's ranks (one
    rank with no group when none is up). Every rank must call it, in the same
    order as every other group it makes."""
    world, rank = pd.get_world_size(), pd.get_rank()
    if data is None:
        if world % (seq * model):
            raise ValueError(f"seq x model = {seq} x {model} must divide the world size {world}")
        data = world // (seq * model)
    if data * seq * model != world:
        raise ValueError(f"mesh {data}x{seq}x{model} != world size {world}")
    shape = {DATA_AXIS: data, SEQ_AXIS: seq, MODEL_AXIS: model}
    coords = {DATA_AXIS: rank // (seq * model), SEQ_AXIS: (rank // model) % seq,
              MODEL_AXIS: rank % model}
    groups: Dict[str, object] = {}
    active = pd.is_initialized()
    for axis in AXES:
        n = shape[axis]
        if not active or (n == 1 and world > 1):
            continue
        if n == world:
            groups[axis] = dist.group.WORLD
            continue
        for ranks in _axis_groups(shape, axis):
            g = dist.new_group(ranks)  # every rank creates every group
            if rank in ranks:
                groups[axis] = g
    return Mesh(shape, coords, groups, active)


def _axis_groups(shape: Mapping[str, int], axis: str):
    """Rank lists of the groups along ``axis``, in a fixed order."""
    d, s, m = shape[DATA_AXIS], shape[SEQ_AXIS], shape[MODEL_AXIS]
    rank = lambda i, j, k: (i * s + j) * m + k  # noqa: E731
    out = []
    for i in range(d):
        for j in range(s):
            for k in range(m):
                c = {DATA_AXIS: i, SEQ_AXIS: j, MODEL_AXIS: k}
                if c[axis] != 0:
                    continue
                ranks = []
                for x in range(shape[axis]):
                    c2 = dict(c, **{axis: x})
                    ranks.append(rank(c2[DATA_AXIS], c2[SEQ_AXIS], c2[MODEL_AXIS]))
                out.append(ranks)
    return out


def fsdp_spec(mesh: Mesh, shape) -> Placement:
    """ZeRO placement (JAX ``_fsdp_spec``): split the largest dim divisible
    by the data size (ties go to the last such dim); whole for tensors under
    ``FSDP_MIN_SIZE`` elements, for scalars and at data size 1."""
    n_data = mesh.size(DATA_AXIS)
    if n_data <= 1 or len(shape) == 0 or math.prod(shape) < FSDP_MIN_SIZE:
        return None
    best = None
    for d, n in enumerate(shape):
        if n % n_data == 0 and n > 1 and (best is None or n >= shape[best]):
            best = d
    return None if best is None else (DATA_AXIS, best)


def dino_placements(mesh: Mesh, params: Mapping[str, torch.Tensor],
                    fsdp: bool = False) -> Dict[str, Placement]:
    """Each student parameter's placement (JAX ``dino_state_shardings``):
    the last layer's ``weight_v`` / ``weight_g`` on out_dim over model,
    then, under ``fsdp``, ``fsdp_spec`` for every other one."""
    out: Dict[str, Placement] = {}
    for name, p in params.items():
        if name.endswith("last_layer.weight_v") or name.endswith("last_layer.weight_g"):
            out[name] = (MODEL_AXIS, 0) if mesh.size(MODEL_AXIS) > 1 else None
        elif fsdp:
            out[name] = fsdp_spec(mesh, tuple(p.shape))
        else:
            out[name] = None
    return out


def shard(mesh: Mesh, full: torch.Tensor, placement: Placement) -> torch.Tensor:
    """This rank's block of ``full`` (a view), or ``full`` when whole."""
    if placement is None:
        return full
    axis, dim = placement
    n = full.shape[dim] // mesh.size(axis)
    return full.narrow(dim, mesh.index(axis) * n, n)


def gather(mesh: Mesh, full: torch.Tensor, placement: Placement) -> None:
    """Refill ``full`` from every rank's block of it, in place."""
    if placement is None:
        return
    axis, dim = placement
    pd.gather_into(full, shard(mesh, full, placement), dim, mesh.group(axis))


def gathered(mesh: Mesh, part: torch.Tensor, placement: Placement) -> torch.Tensor:
    """A new full tensor from every rank's block ``part``."""
    if placement is None:
        return part
    axis, dim = placement
    shape = list(part.shape)
    shape[dim] *= mesh.size(axis)
    full = part.new_empty(shape)
    pd.gather_into(full, part, dim, mesh.group(axis))
    return full


def shard_dino_state(mesh: Mesh, state, fsdp: bool = False):
    """Place a ``DinoTrainState`` on the mesh, in place: record the
    placements, and keep of each split tensor's optimizer moments only this
    rank's block. The modules keep their full tensors: a step computes and
    updates its blocks and all-gathers them back, so every rank ends a step
    with the full state one process would hold. With no group up and
    nothing split this changes nothing."""
    params = dict(state.student.named_parameters())
    placements = dino_placements(mesh, params, fsdp)
    for kind, entries in state.opt_state.items():
        if kind == "count":
            continue
        for name, t in list(entries.items()):
            entries[name] = shard(mesh, t, placements[name]).clone()
    state.mesh = mesh
    state.placements = placements
    return state


def full_opt_state(state) -> dict:
    """The optimizer state with every split moment gathered whole (a
    collective: every rank calls it)."""
    mesh, placements = getattr(state, "mesh", None), getattr(state, "placements", None)
    if mesh is None:
        return state.opt_state
    out = {}
    for kind, entries in state.opt_state.items():
        if kind == "count":
            out[kind] = dict(entries)
            continue
        out[kind] = {n: gathered(mesh, t, placements[n]) for n, t in entries.items()}
    return out
