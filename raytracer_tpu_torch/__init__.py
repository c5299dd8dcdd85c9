"""raytracer_tpu_torch -- the PyTorch/CUDA port of ``raytracer_tpu``.

The forward render path and the gradient pass of the JAX package, for an
NVIDIA H100: the scene DSL, scenes and cameras as tensor dataclasses, the
table packers, the fused path-trace kernel K1 (``csrc/wavefront.cu``) and
its adjoint K5 (``csrc/wavefront_bwd.cu``) written by hand in CUDA, each
with its plain PyTorch version (``ops/cuda/``), the wavefront renderer
differentiated by autograd, inverse rendering, and the reference-parity
path: the golden oracle, the sequential parity renderer and the native C++
engine, and the row-interleaved sharded rendering and gradients of
``parallel``.  Module names follow the JAX package's.  The package imports
neither JAX nor ``raytracer_tpu``, and needs no GPU, ``nvcc``, ``triton``
or C++ compiler to import: the kernels and the native library are built
at their first use.

  L1  maths / mat3 / rng / color /   vector and 3x3 math, pcg3d counters,
      image                          colour and image IO
  L2  scene / camera / parser        tensor dataclasses, the DSL parser
  L3  intersect / materials          closest hit and scatter on wavefronts
  L4  ops (tables, diff, cuda),      K1 + K5 + dispatch, the wavefront
      render                         renderer, framebuffer finish
  L5  grad, api / cli, viewer,       inverse rendering, embedding API, CLI,
      httpviewer, parallel           terminal and browser viewers, meshes
                                     of shards over torch.distributed
      models, utils, oracle,         scene builders, profiling, checkpoints,
      native, certify                golden oracle, C++ engine, certification
"""

from . import maths, mat3, rng, color, image
from . import scene, camera, parser
from . import intersect, materials
from . import models, ops, render, grad, oracle

from .camera import Camera, camera_from_arrays
from .render import (Options, ray_trace, ray_trace_parity, render_linear,
                     finalize_image)
from .scene import (Scene, Materials, build_scene, build_materials,
                    scene_from_arrays, DIFFUSE, METAL, DIELECTRIC, EMISSION)
from .parser import parse_input, parse_world, ParseError

__version__ = "0.1.0"
