"""Finite-difference gradient check (port of
``raytracer_tpu/grad/finite_diff.py``): central differences of the loss,
one coordinate at a time, to validate autograd and K5."""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch


def finite_diff_grad(loss_fn: Callable, params: Mapping[str, torch.Tensor],
                     eps: float = 1e-3) -> Dict[str, np.ndarray]:
    """Central-difference gradient of ``loss_fn`` at ``params`` as float64
    numpy arrays.  Each coordinate is bumped in float64 and the bumped
    params are rounded to float32 on their device.  O(2 x coordinates)
    renders: keep the configurations tiny."""
    base = {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in params.items()}
    devices = {k: v.device for k, v in params.items()}
    grads = {k: np.zeros_like(v) for k, v in base.items()}
    with torch.no_grad():
        for key, leaf in base.items():
            for idx in np.ndindex(leaf.shape):
                for sign in (1.0, -1.0):
                    bumped = dict(base)
                    bumped[key] = leaf.copy()
                    bumped[key][idx] += sign * eps
                    p = {k: torch.from_numpy(v.astype(np.float32)).to(
                        devices[k]) for k, v in bumped.items()}
                    grads[key][idx] += sign * float(loss_fn(p))
                grads[key][idx] /= 2.0 * eps
    return grads
