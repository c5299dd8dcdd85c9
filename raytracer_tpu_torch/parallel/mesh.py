"""Device meshes (port of ``raytracer_tpu/parallel/mesh.py``).

The JAX package shards the ray wavefront over a 1-D ``rays`` mesh: the
scene is replicated, pixels are the sharded dimension, and the only
collectives are the gradient sum and the segment count.  A ``Mesh`` here is
the same 1-D axis of ``size`` shards, in the two forms a PyTorch user has:

  * one process over several devices (JAX's single controller):
    ``make_mesh(n)`` names the first ``n`` local CUDA devices, or ``n``
    shards on the CPU with ``device="cpu"`` (the counterpart of the virtual
    CPU devices the JAX tests use); a ``Mesh`` may also name one device
    several times, which runs its shards one after another;
  * several processes (``torch.distributed``): after
    ``initialize_distributed()``, ``make_mesh`` puts the process group on
    the mesh.  Shard ``k`` of the ``world_size * len(devices)`` shards
    lives on rank ``k // len(devices)``, at local device
    ``k % len(devices)``.

``replicated`` and ``ray_sharded`` are JAX's ``NamedSharding``s.  Their
torch form says where a tensor goes: ``replicated(mesh)`` is the devices a
replicated scene is copied to, ``ray_sharded(mesh)`` each local shard's
device and its interleaved slice of a sharded axis.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["RAYS_AXIS", "Mesh", "make_mesh", "replicated", "ray_sharded",
           "pad_to_multiple", "Shard"]

RAYS_AXIS = "rays"


class Shard(NamedTuple):
    """One local shard: its global index on the mesh and its device."""
    index: int
    device: torch.device


class Mesh:
    """A 1-D mesh of shards: this process's ``devices`` (one per local
    shard, repeats allowed) and, across processes, the ``group`` (None in
    one process)."""

    def __init__(self, devices: Sequence, axis_name: str = RAYS_AXIS,
                 group=None):
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh's devices are of one type, got "
                             f"{self.devices}")
        self.axis_name = axis_name
        self.group = group

    @property
    def world_size(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Shards over all processes."""
        return self.world_size * len(self.devices)

    @property
    def shape(self) -> dict:
        """``{axis_name: size}``, as a JAX mesh's ``shape``."""
        return {self.axis_name: self.size}

    @property
    def device(self) -> torch.device:
        """Where results are gathered: the first local device."""
        return self.devices[0]

    def local_shards(self) -> Tuple[Shard, ...]:
        base = self.rank * len(self.devices)
        return tuple(Shard(base + j, d) for j, d in enumerate(self.devices))

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_name}={self.size}, devices="
                f"{[str(d) for d in self.devices]}, world_size="
                f"{self.world_size})")


def _visible(device_type: str) -> int:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' needs an NVIDIA GPU (torch.cuda.is_available() "
                "is false); pass device=\"cpu\" to run on the CPU")
        return torch.cuda.device_count()
    if device_type != "cpu":
        raise ValueError(f"unsupported device type {device_type!r}")
    return 1


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              axis_name: str = RAYS_AXIS) -> Mesh:
    """1-D mesh over ``n_devices`` shards in all (every process's, when
    ``torch.distributed`` is initialised; then the mesh carries its default
    group and each rank holds ``n_devices / world_size`` of them).

    On CUDA the shards are the first local devices (from ``LOCAL_RANK *
    per-rank count`` under a group, one GPU per rank by default, as
    ``torchrun`` starts them); past the visible count it raises
    ``ValueError``.  On the CPU (``device="cpu"``) every shard is the CPU
    and ``n_devices`` defaults to one per process."""
    import torch.distributed as dist
    dtype = torch.device(device).type
    visible = _visible(dtype)
    group = dist.group.WORLD if (dist.is_available()
                                 and dist.is_initialized()) else None
    world = 1 if group is None else dist.get_world_size(group)
    if n_devices is None:
        per_rank = visible if (dtype == "cuda" and world == 1) else 1
    else:
        if n_devices < world or n_devices % world:
            raise ValueError(f"{n_devices} shards do not divide over "
                             f"{world} processes")
        per_rank = n_devices // world
    if dtype == "cpu":
        return Mesh(["cpu"] * per_rank, axis_name, group)
    base = int(os.environ.get("LOCAL_RANK", 0)) * per_rank if world > 1 \
        else 0
    if base + per_rank > visible:
        raise ValueError(f"requested {per_rank} devices from cuda:{base}, "
                         f"only {visible} visible")
    return Mesh([f"cuda:{base + j}" for j in range(per_rank)], axis_name,
                group)


def replicated(mesh: Mesh) -> Tuple[torch.device, ...]:
    """Where a replicated tensor lives: every distinct local device."""
    return tuple(dict.fromkeys(mesh.devices))


def ray_sharded(mesh: Mesh, axis_name: str = RAYS_AXIS
                ) -> Tuple[Tuple[torch.device, slice], ...]:
    """How an axis sharded over ``axis_name`` is laid out, interleaved as
    the renderers do: each local shard's (device, slice) of the axis,
    shard i holding elements i, i + n, i + 2n, ..."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh's axis is {mesh.axis_name!r}, not "
                         f"{axis_name!r}")
    n = mesh.size
    return tuple((s.device, slice(s.index, None, n))
                 for s in mesh.local_shards())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
