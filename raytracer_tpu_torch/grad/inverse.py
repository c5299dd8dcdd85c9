"""Inverse rendering: recover scene parameters from a target image.

Port of ``raytracer_tpu/grad/inverse.py``.  The loss is L2 on the LINEAR
mean radiance image (before gamma and the u8 cast), rendered with a fixed
seed so the objective is deterministic.  Gradients follow the selected
branch of every hit and material decision (correct almost everywhere;
``make_loss_fn`` leaves the visibility-boundary terms out, the standard
differentiable ray-tracing baseline, and the silhouette step below adds
them).

Engines of ``make_loss_fn`` (the JAX names, mapped onto the port):

  * ``"xla"``    -- autograd through the port's wavefront renderer
    (``render.render_linear``);
  * ``"pallas"`` -- ``ops.diff.render_linear_diff``: K1 forward, K5
    backward (their plain PyTorch versions on CPU tensors).  Under the
    correct plane sign triangles cull through ``ops.diff.build_tri_cull``
    (built once here, at its default leaf size): a mesh whose packed
    tables pass the JAX package's table budget (the bench's 164k-triangle
    scene) takes the two-level walk of K2 and K5s in leaves of 128, every
    other scene (OBJ-10k included) one level of leaves of 64 through K1
    and K5;
  * ``"auto"``   -- ``"pallas"`` on a CUDA device, ``"xla"`` on the CPU,
    as the JAX package picks the kernels on a TPU and XLA on a CPU.

The default stays ``"xla"``, the JAX default.  ``make_loss_fn`` and ``fit``
run on ``device`` (default ``"cuda"``, as ``render.Options``): the scene,
camera, target and params move there, and a CUDA device without a GPU
raises rather than fall back to the CPU (``device="cpu"`` asks for it).
PyTorch's ``torch.optim`` takes the place of optax: the optimiser owns the
param tensors and a train step updates them in place.
``torch.optim.Adam``'s defaults are ``optax.adam``'s.
``make_silhouette_train_step`` and ``fit(silhouette=True)`` add the
visibility-boundary terms of ``grad/silhouette.py`` to the interior
gradient, so geometry can be pulled across its own silhouette under the
unmasked loss; the silhouette fit is single-device, as in the JAX
package.

``mesh=`` (a ``parallel.Mesh``) shards the loss's render over the mesh, as
the JAX package routes it: ``"pallas"`` through
``parallel.render_linear_diff_sharded`` (K1 + K5, or K2 + K5s, per shard)
and ``"xla"`` through ``parallel.render_linear_sharded``; the scene's
gradients are summed over the shards, and the loss, its target and the
params live on the mesh's first device (``device`` is not read).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

import torch

from .. import render as render_mod
from ..camera import Camera
from ..ops import diff as diff_mod
from ..scene import Scene
from ..utils import checkpoint as ckpt_mod
from .params import apply_params

__all__ = ["ENGINES", "image_loss", "make_loss_fn", "make_train_step",
           "make_silhouette_train_step", "fit", "FitResult"]

ENGINES = ("auto", "xla", "pallas")

def image_loss(rendered_linear: torch.Tensor, target_linear: torch.Tensor
               ) -> torch.Tensor:
    """Mean squared error over pixels and channels."""
    diff = rendered_linear - target_linear
    return torch.mean(diff * diff)


def _device(device) -> torch.device:
    """``device`` as a torch.device with its index; a CUDA device without
    a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' needs an NVIDIA GPU (torch.cuda.is_available() "
                "is false); pass device=\"cpu\" to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def _move(x, device):
    """A scene or camera on ``device`` (itself when it is there already, so
    caches keyed on its identity still hit)."""
    return x if x.device == device else x.to(device)


def make_loss_fn(scene: Scene, camera: Camera, target_linear, *,
                 width: int, height: int, samples_per_pixel: int, depth: int,
                 seed: int = 0, mesh=None, parity_plane_sign: bool = True,
                 engine: str = "xla", device="cuda") -> Callable:
    """loss(params) -> scalar tensor, differentiable in the params (a dict
    of PARAM_FIELDS tensors, moved to ``device`` inside the loss).  With a
    ``mesh`` the render is sharded over it and ``device`` is its first
    device."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    device = _device(device if mesh is None else mesh.device)
    scene, camera = _move(scene, device), _move(camera, device)
    if engine == "auto":
        engine = "pallas" if device.type == "cuda" else "xla"
    # static cluster topology for K1/K5, bounds recomputed from the live
    # vertices every call; only with the correct plane equation
    tri_cull = (diff_mod.build_tri_cull(scene)
                if engine == "pallas" and not parity_plane_sign else None)
    target = torch.as_tensor(target_linear, dtype=torch.float32,
                             device=device)
    shape = dict(width=width, height=height,
                 samples_per_pixel=samples_per_pixel, depth=depth,
                 seed=seed, parity_plane_sign=parity_plane_sign)

    def loss(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        s = apply_params(scene, {k: v.to(device) for k, v in params.items()})
        if mesh is not None and engine == "pallas":
            from ..parallel.sharding import render_linear_diff_sharded
            img = render_linear_diff_sharded(s, camera, mesh=mesh,
                                             tri_cull=tri_cull, **shape)
        elif mesh is not None:
            from ..parallel.sharding import render_linear_sharded
            img, _ = render_linear_sharded(s, camera, mesh=mesh, **shape)
        elif engine == "pallas":
            img = diff_mod.render_linear_diff(s, camera, tri_cull=tri_cull,
                                              **shape)
        else:
            img, _ = render_mod.render_linear(s, camera, **shape)
        return image_loss(img, target)

    return loss


def make_train_step(loss_fn: Callable, optimizer: torch.optim.Optimizer
                    ) -> Callable:
    """One optimiser step, the counterpart of the JAX package's
    ``make_train_step`` ((params, opt_state) -> (params', opt_state',
    loss)).  Here ``optimizer`` owns the param tensors (leaves with
    ``requires_grad``): ``step(params)`` evaluates the loss, back-propagates,
    updates the tensors in place and returns the loss before the update."""

    def step(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_silhouette_train_step(scene: Scene, camera: Camera, target,
                               optimizer: torch.optim.Optimizer, *,
                               width: int, height: int,
                               samples_per_pixel: int, depth: int,
                               parity_plane_sign: bool = True,
                               seed: int = 0, n_edge: int = 512,
                               samples_per_edge: int = 16,
                               max_edges: Optional[int] = None,
                               device="cuda") -> Callable:
    """Train step whose gradients include the visibility-boundary terms
    (``grad/silhouette.py``): optimisation can move a silhouette across the
    image instead of stalling where interior gradients vanish.
    ``optimizer`` owns the param tensors: ``step(params)`` sets each
    tensor's ``.grad`` from ``value_and_grad_with_silhouette``, steps, and
    returns the loss before the update."""
    from .silhouette import MAX_EDGE_SAMPLES, value_and_grad_with_silhouette
    me = MAX_EDGE_SAMPLES if max_edges is None else max_edges
    device = _device(device)
    scene, camera = _move(scene, device), _move(camera, device)
    shape = dict(width=width, height=height,
                 samples_per_pixel=samples_per_pixel, depth=depth,
                 parity_plane_sign=parity_plane_sign, seed=seed,
                 n_edge=n_edge, samples_per_edge=samples_per_edge,
                 max_edges=me, device=device)

    def step(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        loss, grads = value_and_grad_with_silhouette(
            scene, camera, target, params, **shape)
        for k, v in params.items():
            v.grad = grads[k].to(v.device)
        optimizer.step()
        return loss

    return step


@dataclasses.dataclass
class FitResult:
    params: Dict[str, torch.Tensor]
    losses: List[float]
    steps_run: int


def fit(scene: Scene, camera: Camera, target_linear,
        params_init: Mapping[str, torch.Tensor], *, width: int, height: int,
        samples_per_pixel: int = 4, depth: int = 4, steps: int = 200,
        learning_rate: float = 1e-2, seed: int = 0, mesh=None,
        optimizer: Optional[Callable] = None, silhouette: bool = False,
        checkpoint_path: Optional[str] = None, checkpoint_every: int = 50,
        resume: bool = True, log_every: int = 0,
        device="cuda") -> FitResult:
    """Adam descent on the pixel loss, with npz checkpoints and resume.

    ``optimizer``: a factory ``optimizer(list_of_tensors)`` returning a
    ``torch.optim.Optimizer`` (default ``torch.optim.Adam`` at
    ``learning_rate``).  The params are copied: ``params_init`` is never
    changed.  With ``checkpoint_path`` and ``resume``, a checkpoint found
    there restores the params, the optimiser state, the step and the
    losses, and the fit runs on from that step.  The optimised params live
    on ``device``, or with a ``mesh`` on its first device, the loss's
    render sharded over it.  ``silhouette=True`` adds the
    visibility-boundary terms (``make_silhouette_train_step``); that fit is
    single-device, and raises with a mesh."""
    if silhouette and mesh is not None:
        raise ValueError("the silhouette fit is single-device (mesh=None)")
    device = _device(device if mesh is None else mesh.device)
    params = {k: v.detach().to(device).clone().requires_grad_(True)
              for k, v in params_init.items()}
    make_opt = optimizer or (lambda ps: torch.optim.Adam(
        ps, lr=learning_rate))
    opt = make_opt(list(params.values()))
    shape = dict(width=width, height=height,
                 samples_per_pixel=samples_per_pixel, depth=depth, seed=seed,
                 device=device)
    if silhouette:
        step_fn = make_silhouette_train_step(scene, camera, target_linear,
                                             opt, **shape)
    else:
        step_fn = make_train_step(make_loss_fn(
            scene, camera, target_linear, mesh=mesh, **shape), opt)

    start_step = 0
    losses: List[float] = []
    if checkpoint_path and resume:
        restored = ckpt_mod.load(checkpoint_path)
        if restored is not None:
            saved, opt_state, start_step, losses = restored
            if set(saved) != set(params):
                raise ValueError(f"checkpoint holds params {sorted(saved)}, "
                                 f"the fit optimises {sorted(params)}")
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(torch.from_numpy(saved[k]).to(device))
            opt.load_state_dict(opt_state)

    for i in range(start_step, steps):
        losses.append(float(step_fn(params)))
        if log_every and i % log_every == 0:
            print(f"[fit] step {i} loss {losses[-1]:.6e}")
        if checkpoint_path and checkpoint_every and \
                ((i + 1) % checkpoint_every == 0 or i + 1 == steps):
            ckpt_mod.save(checkpoint_path, params, opt, i + 1, losses)

    return FitResult(params={k: v.detach() for k, v in params.items()},
                     losses=losses, steps_run=steps - start_step)
