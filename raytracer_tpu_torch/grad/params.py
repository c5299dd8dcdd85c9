"""Optimisable scene parameters (port of ``raytracer_tpu/grad/params.py``).

A parameter set is a plain dict mapping field names to float32 tensors; it
can cover any differentiable leaf of the Scene: sphere centres and radii,
triangle vertices, and the material table's colour (albedo), metal fuzz and
dielectric ir.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping

import numpy as np
import torch

from ..scene import Scene

__all__ = ["PARAM_FIELDS", "extract_params", "apply_params",
           "params_from_arrays"]

PARAM_FIELDS = (
    "sphere_center", "sphere_radius",
    "tri_v0", "tri_v1", "tri_v2",
    "mat_color", "mat_fuzz", "mat_ir",
)

_MATERIAL_FIELDS = {"mat_color": "color", "mat_fuzz": "fuzz", "mat_ir": "ir"}


def _check(field: str) -> None:
    if field not in PARAM_FIELDS:
        raise ValueError(f"unknown param field {field!r}; valid: "
                         f"{PARAM_FIELDS}")


def extract_params(scene: Scene, fields: Iterable[str]
                   ) -> Dict[str, torch.Tensor]:
    """The named fields of ``scene`` as a dict of detached copies: an
    optimiser may update them in place without touching the scene."""
    params = {}
    for f in fields:
        _check(f)
        src = (getattr(scene.materials, _MATERIAL_FIELDS[f])
               if f in _MATERIAL_FIELDS else getattr(scene, f))
        params[f] = src.detach().clone()
    return params


def apply_params(scene: Scene, params: Mapping[str, torch.Tensor]) -> Scene:
    """A Scene with the given fields replaced by the param tensors (the
    tensors themselves, so autograd reaches them)."""
    scene_updates = {}
    material_updates = {}
    for f, v in params.items():
        _check(f)
        if f in _MATERIAL_FIELDS:
            material_updates[_MATERIAL_FIELDS[f]] = v
        else:
            scene_updates[f] = v
    if material_updates:
        scene_updates["materials"] = dataclasses.replace(
            scene.materials, **material_updates)
    return dataclasses.replace(scene, **scene_updates)


def params_from_arrays(arrays: Mapping[str, np.ndarray], device
                       ) -> Dict[str, torch.Tensor]:
    """A param dict of the JAX package (arrays keyed by PARAM_FIELDS) as
    float32 tensors on ``device``."""
    out = {}
    for f, a in arrays.items():
        _check(f)
        out[f] = torch.from_numpy(
            np.array(a, np.float32, order="C")).to(device)
    return out
