"""Process bootstrap over ``torch.distributed`` (port of
``raytracer_tpu/parallel/distributed.py``).

The JAX package leaves transport to ``jax.distributed`` and XLA's
collectives; here the process group is ``torch.distributed``'s, NCCL
between CUDA devices and gloo on the CPU.  This module owns process
bootstrap and the host-local mesh only; the collectives are in
``sharding.py``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .mesh import RAYS_AXIS, Mesh, _visible

__all__ = ["initialize_distributed", "is_multi_host", "host_local_mesh"]

_CLUSTER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device="cuda") -> None:
    """Idempotent ``torch.distributed.init_process_group``.

    With a ``coordinator_address`` (``host:port``, ``tcp://host:port`` or a
    ``file://`` rendezvous path) the group has ``num_processes`` ranks and
    this process is ``process_id``; without one, ``torchrun``'s variables
    (RANK, WORLD_SIZE, MASTER_ADDR, ...) describe it.  When neither is
    there this does nothing, as the JAX package's does on one host.  The
    backend is NCCL for ``device="cuda"`` and gloo for the CPU.
    """
    import torch.distributed as dist
    if dist.is_initialized():
        return
    in_cluster = all(k in os.environ for k in _CLUSTER_VARS)
    if coordinator_address is None and not in_cluster:
        return
    dtype = torch.device(device).type
    _visible(dtype)
    kw = dict(backend="nccl" if dtype == "cuda" else "gloo")
    if coordinator_address is None:
        kw["init_method"] = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        addr = coordinator_address
        if "://" not in addr:
            addr = "tcp://" + addr
        kw.update(init_method=addr, world_size=num_processes,
                  rank=process_id)
    dist.init_process_group(**kw)


def is_multi_host() -> bool:
    """Whether a process group of more than one rank is up."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def host_local_mesh(axis_name: str = RAYS_AXIS, device="cuda") -> Mesh:
    """Mesh over this process's devices only, with no process group (for
    host-local work; global meshes come from ``mesh.make_mesh``): every
    visible CUDA device, or one CPU shard."""
    dtype = torch.device(device).type
    n = _visible(dtype)
    if dtype == "cpu":
        return Mesh(["cpu"], axis_name)
    return Mesh([f"cuda:{j}" for j in range(n)], axis_name)
