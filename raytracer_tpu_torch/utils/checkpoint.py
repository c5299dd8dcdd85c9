"""Checkpoints of an optimisation as one ``.npz`` file, without pickle.

Port of ``raytracer_tpu/utils/checkpoint.py`` for PyTorch: the params (a
dict of tensors), the tensors of the optimiser's ``state_dict``, the step
and the losses.  The state dict's other entries (the param groups'
hyper-parameters, the state's keys) go into a JSON string, so loading runs
no code.  Saving writes a temporary file beside the target and renames it,
so a crash never leaves a half-written checkpoint.  Checkpoints of the JAX
package are not readable here.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save", "load"]


def save(path: str, params: Dict[str, torch.Tensor],
         optimizer: torch.optim.Optimizer, step: int,
         losses: List[float]) -> None:
    """Write (params, optimizer state, step, losses) to ``path``."""
    arrays: Dict[str, np.ndarray] = {}

    def encode(value, key):
        if isinstance(value, torch.Tensor):
            arrays[key] = value.detach().cpu().numpy()
            return {"__array__": key}
        if isinstance(value, dict):
            return {"__dict__": [[encode(k, f"{key}.k{i}"),
                                  encode(v, f"{key}.v{i}")]
                                 for i, (k, v) in enumerate(value.items())]}
        if isinstance(value, (list, tuple)):
            return {"__list__": [encode(v, f"{key}.{i}")
                                 for i, v in enumerate(value)],
                    "tuple": isinstance(value, tuple)}
        return value

    for name, t in params.items():
        arrays[f"param.{name}"] = t.detach().cpu().numpy()
    meta = {"step": int(step), "params": list(params),
            "optimizer": encode(optimizer.state_dict(), "opt")}
    arrays["losses"] = np.asarray(losses, np.float64)
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        # pass the handle: np.savez appends ".npz" to a bare path
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str) -> Optional[Tuple[Dict[str, np.ndarray], dict, int,
                                      List[float]]]:
    """(params as numpy arrays, the optimiser's state_dict with CPU
    tensors, step, losses) from ``path``, or None if there is no file."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())

        def decode(value):
            if isinstance(value, dict) and "__array__" in value:
                return torch.from_numpy(np.array(z[value["__array__"]]))
            if isinstance(value, dict) and "__dict__" in value:
                return {decode(k): decode(v) for k, v in value["__dict__"]}
            if isinstance(value, dict) and "__list__" in value:
                items = [decode(v) for v in value["__list__"]]
                return tuple(items) if value["tuple"] else items
            return value

        params = {k: np.array(z[f"param.{k}"]) for k in meta["params"]}
        state = decode(meta["optimizer"])
        losses = [float(x) for x in z["losses"]]
    return params, state, int(meta["step"]), losses
