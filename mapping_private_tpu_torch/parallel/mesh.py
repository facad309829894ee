"""Device meshes over ``torch.distributed`` ranks.

Counterpart of ``mapping_private_tpu/parallel/mesh.py``: scan batches
shard over ``dp`` (data parallel), points within a scan over ``sp``
(spatial parallel), and voxel-map blocks over every axis jointly.  Where
JAX builds one program over a grid of devices, the port runs one process
per rank: a mesh is a ``DeviceMesh`` over the ranks of the default
process group, and each mesh axis carries the process group that the
steps' collectives run on (``mesh.get_group("sp")``).

The caller initialises the default process group
(``torch.distributed.init_process_group``) and, on the card, selects
each rank's device (``torch.cuda.set_device``) first; nothing here does
either.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("dp", "sp"),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh of shape ``axis_sizes`` over ranks 0 .. prod(sizes) − 1,
    laid out row-major (rank = dp index · sp + sp index on (dp, sp)).

    Without explicit sizes every rank goes on the first axis and 1 on the
    others.  Ranks beyond the mesh hold no coordinate in it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group (init_process_group)")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} sizes for {tuple(axis_names)}")
    total = 1
    for s in axis_sizes:
        total *= int(s)
    if total > world:
        raise ValueError(f"mesh {tuple(axis_sizes)} needs {total} ranks, have {world}")
    ranks = torch.arange(total).reshape(tuple(int(s) for s in axis_sizes))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# What the sharded steps share: this rank's pieces of a global array, and
# the collectives on a mesh axis's process group.


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's pieces go to: the mesh's device type, at the
    current device of that type (the caller's ``torch.cuda.set_device``)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_index(mesh: DeviceMesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(k, n): this rank's block among the n blocks of an array sharded
    over ``axes`` jointly, as ``PartitionSpec(axes)`` lays it out: the
    first axis major."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError(f"rank {dist.get_rank()} holds no coordinate in {mesh}")
    names = list(mesh.mesh_dim_names)
    k, n = 0, 1
    for a in axes:
        i = names.index(a)
        k, n = k * mesh.shape[i] + coord[i], n * mesh.shape[i]
    return k, n


def block(a, k: int, n: int, dim: int = 0):
    """Block k of n equal blocks of ``a`` (numpy array or tensor) along ``dim``."""
    size = a.shape[dim]
    if size % n:
        raise ValueError(f"dimension {dim} of size {size} does not split into {n} equal blocks")
    b = size // n
    return a[(slice(None),) * dim + (slice(k * b, (k + 1) * b),)]


def to_mesh_device(mesh: DeviceMesh, a) -> torch.Tensor:
    return torch.as_tensor(a).to(mesh_device(mesh))


def _through_host(t: torch.Tensor, group) -> bool:
    """gloo runs no collective on card memory: its payload goes through the
    host (a copy there and back), which is what two ranks on one card use."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (``psum``), as a new tensor
    on ``t``'s device."""
    out = t.cpu() if _through_host(t, group) else t.clone()
    dist.all_reduce(out, group=group)
    return out.to(t.device)


# all_gather_into_tensor is named all_gather_single in later releases
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """(ranks of ``group``, *t.shape): every rank's ``t`` in the group's rank
    order (``all_gather`` over one mesh axis), on ``t``'s device."""
    src = t.cpu() if _through_host(t, group) else t.contiguous()
    n = dist.get_world_size(group)
    out = src.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))  # the concatenation: gloo takes no stack
    _all_gather_single(out, src, group=group)
    return out.reshape((n,) + tuple(t.shape)).to(t.device)
