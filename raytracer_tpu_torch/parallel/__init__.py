"""Parallel layer: meshes of shards, sharded rendering and gradients,
process bootstrap (port of ``raytracer_tpu/parallel``).

One process drives several devices (``make_mesh(n)``, or ``n`` shards on
the CPU), or several processes join a ``torch.distributed`` group
(``initialize_distributed``, then ``make_mesh``).  Shards trace interleaved
rows, tile rows or pixels of the frame; the gathered image is the
one-device image.
"""

from .mesh import (RAYS_AXIS, Mesh, make_mesh, pad_to_multiple, ray_sharded,
                   replicated)
from .sharding import (render_linear_sharded, render_linear_sharded_fast,
                       render_linear_diff_sharded, ray_trace_sharded)
from .distributed import initialize_distributed, is_multi_host, host_local_mesh

__all__ = [
    "RAYS_AXIS", "make_mesh", "pad_to_multiple", "ray_sharded", "replicated",
    "render_linear_sharded", "render_linear_sharded_fast",
    "ray_trace_sharded",
    "initialize_distributed", "is_multi_host", "host_local_mesh",
    "render_linear_diff_sharded", "Mesh",
]
