"""Differentiable rendering and inverse rendering (port of
``raytracer_tpu/grad``): parameter dicts, the image loss through the
wavefront autograd or K1 + K5, optimiser steps and ``fit``, and a
finite-difference check.  ``grad/silhouette.py`` is not ported yet."""

from .params import (PARAM_FIELDS, apply_params, extract_params,
                     params_from_arrays)
from .inverse import (FitResult, fit, image_loss, make_loss_fn,
                      make_silhouette_train_step, make_train_step)
from .finite_diff import finite_diff_grad

__all__ = [
    "PARAM_FIELDS", "apply_params", "extract_params", "params_from_arrays",
    "image_loss", "make_loss_fn", "make_train_step",
    "make_silhouette_train_step", "fit", "FitResult", "finite_diff_grad",
]
