"""Differentiable rendering and inverse rendering (port of
``raytracer_tpu/grad``): parameter dicts, the image loss through the
wavefront autograd or K1 + K5, optimiser steps and ``fit``, a
finite-difference check and the silhouette (visibility-boundary)
gradients of ``grad/silhouette.py``."""

from .params import (PARAM_FIELDS, apply_params, extract_params,
                     params_from_arrays)
from .inverse import (FitResult, fit, image_loss, make_loss_fn,
                      make_silhouette_train_step, make_train_step)
from .finite_diff import finite_diff_grad
from .silhouette import (glass_silhouette_grad, mirror_silhouette_grad,
                         mirror_triangle_silhouette_grad, silhouette_grad,
                         triangle_silhouette_grad,
                         value_and_grad_with_silhouette)

__all__ = [
    "PARAM_FIELDS", "apply_params", "extract_params", "params_from_arrays",
    "image_loss", "make_loss_fn", "make_train_step",
    "make_silhouette_train_step", "fit", "FitResult", "finite_diff_grad",
    "silhouette_grad", "mirror_silhouette_grad", "glass_silhouette_grad",
    "mirror_triangle_silhouette_grad", "triangle_silhouette_grad",
    "value_and_grad_with_silhouette",
]
