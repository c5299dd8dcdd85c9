"""Inverse rendering: recover scene parameters from a target image.

Port of ``raytracer_tpu/grad/inverse.py``.  The loss is L2 on the LINEAR
mean radiance image (before gamma and the u8 cast), rendered with a fixed
seed so the objective is deterministic.  Gradients follow the selected
branch of every hit and material decision (correct almost everywhere;
visibility-boundary terms are left out, the standard differentiable
ray-tracing baseline).

Engines of ``make_loss_fn`` (the JAX names, mapped onto the port):

  * ``"xla"``    -- autograd through the port's wavefront renderer
    (``render.render_linear``), on the scene's device;
  * ``"pallas"`` -- ``ops.diff.render_linear_diff``: K1 forward, K5
    backward (their plain PyTorch versions on CPU tensors);
  * ``"auto"``   -- ``"pallas"`` on a CUDA device, ``"xla"`` on the CPU,
    as the JAX package picks the kernels on a TPU and XLA on a CPU.

The default stays ``"xla"``, the JAX default.  PyTorch's ``torch.optim``
takes the place of optax: the optimiser owns the param tensors and a train
step updates them in place.  ``torch.optim.Adam``'s defaults are
``optax.adam``'s.  Not ported yet, and raising ``NotImplementedError``:
sharded rendering (``mesh=``, the ``parallel/`` item of ROADMAP.md's
modules still to port) and the silhouette gradients (``grad/silhouette.py``,
the ``silhouette`` item there).
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

_NO_MESH = ("mesh= is not ported yet: sharded rendering is the 'parallel/' "
            "item of ROADMAP.md's modules still to port")
_NO_SILHOUETTE = ("silhouette gradients are not ported yet: "
                  "grad/silhouette.py is the 'silhouette' item of "
                  "ROADMAP.md's modules still to port")


def image_loss(rendered_linear: torch.Tensor, target_linear: torch.Tensor
               ) -> torch.Tensor:
    """Mean squared error over pixels and channels."""
    diff = rendered_linear - target_linear
    return torch.mean(diff * diff)


def make_loss_fn(scene: Scene, camera: Camera, target_linear, *,
                 width: int, height: int, samples_per_pixel: int, depth: int,
                 seed: int = 0, mesh=None, parity_plane_sign: bool = True,
                 engine: str = "xla") -> Callable:
    """loss(params) -> scalar tensor, differentiable in the params (a dict
    of PARAM_FIELDS tensors on the scene's device)."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    if engine == "auto":
        engine = "pallas" if scene.device.type == "cuda" else "xla"
    # static cluster topology for K1/K5, bounds recomputed from the live
    # vertices every call; only with the correct plane equation
    tri_cull = (diff_mod.build_tri_cull(scene)
                if engine == "pallas" and not parity_plane_sign else None)
    target = torch.as_tensor(target_linear, dtype=torch.float32,
                             device=scene.device)
    shape = dict(width=width, height=height,
                 samples_per_pixel=samples_per_pixel, depth=depth,
                 seed=seed, parity_plane_sign=parity_plane_sign)

    def loss(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
        s = apply_params(scene, params)
        if engine == "pallas":
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


def make_silhouette_train_step(*args, **kwargs):
    """Not ported yet (``grad/silhouette.py``)."""
    raise NotImplementedError(_NO_SILHOUETTE)


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
        resume: bool = True, log_every: int = 0) -> FitResult:
    """Adam descent on the pixel loss, with npz checkpoints and resume.

    ``optimizer``: a factory ``optimizer(list_of_tensors)`` returning a
    ``torch.optim.Optimizer`` (default ``torch.optim.Adam`` at
    ``learning_rate``).  The params are copied: ``params_init`` is never
    changed.  With ``checkpoint_path`` and ``resume``, a checkpoint found
    there restores the params, the optimiser state, the step and the
    losses, and the fit runs on from that step."""
    if mesh is not None:
        raise NotImplementedError(_NO_MESH)
    if silhouette:
        raise NotImplementedError(_NO_SILHOUETTE)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params_init.items()}
    make_opt = optimizer or (lambda ps: torch.optim.Adam(
        ps, lr=learning_rate))
    opt = make_opt(list(params.values()))
    step_fn = make_train_step(make_loss_fn(
        scene, camera, target_linear, width=width, height=height,
        samples_per_pixel=samples_per_pixel, depth=depth, seed=seed), opt)

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
                    v.copy_(torch.from_numpy(saved[k]))
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
