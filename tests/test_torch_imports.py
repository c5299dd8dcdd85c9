"""Import hygiene of raytracer_tpu_torch, checked in a fresh interpreter:
importing the package or any module of the slice loads no ``jax`` and no
``raytracer_tpu`` module, and works with ``triton`` unavailable."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "raytracer_tpu_torch",
    "raytracer_tpu_torch.rng",
    "raytracer_tpu_torch.maths",
    "raytracer_tpu_torch.intersect",
    "raytracer_tpu_torch.materials",
    "raytracer_tpu_torch.scene",
    "raytracer_tpu_torch.camera",
    "raytracer_tpu_torch.parser",
    "raytracer_tpu_torch.image",
    "raytracer_tpu_torch.models",
    "raytracer_tpu_torch.models.builders",
    "raytracer_tpu_torch.models.obj",
    "raytracer_tpu_torch.ops",
    "raytracer_tpu_torch.ops.tables",
    "raytracer_tpu_torch.ops.cuda",
    "raytracer_tpu_torch.ops.cuda.build",
    "raytracer_tpu_torch.ops.cuda.wavefront",
    "raytracer_tpu_torch.ops.cuda.wavefront_bwd",
    "raytracer_tpu_torch.ops.cuda.wavefront_stream",
    "raytracer_tpu_torch.ops.cuda.wavefront_binned",
    "raytracer_tpu_torch.ops.cuda.wavefront_sorted",
    "raytracer_tpu_torch.ops.diff",
    "raytracer_tpu_torch.render",
    "raytracer_tpu_torch.utils.profiling",
    "raytracer_tpu_torch.utils.checkpoint",
    "raytracer_tpu_torch.grad",
    "raytracer_tpu_torch.grad.params",
    "raytracer_tpu_torch.grad.finite_diff",
    "raytracer_tpu_torch.grad.inverse",
    "raytracer_tpu_torch.grad.silhouette",
    "raytracer_tpu_torch.api",
    "raytracer_tpu_torch.cli",
    "raytracer_tpu_torch.oracle",
    "raytracer_tpu_torch.native",
    "raytracer_tpu_torch.certify",
    "raytracer_tpu_torch.viewer",
    "raytracer_tpu_torch.httpviewer",
    "raytracer_tpu_torch.parallel",
    "raytracer_tpu_torch.parallel.mesh",
    "raytracer_tpu_torch.parallel.distributed",
    "raytracer_tpu_torch.parallel.sharding",
    "raytracer_tpu_torch.color",
    "raytracer_tpu_torch.mat3",
]

# Each module is imported in the same fresh interpreter, one after the
# other, recording the foreign modules loaded after each import.  ``triton``
# is blocked (sys.modules[name] = None makes its import raise).
_PROBE = """
import importlib, json, sys
sys.modules["triton"] = None
out = {}
for name in %r:
    importlib.import_module(name)
    out[name] = sorted(m for m in sys.modules if m.split(".")[0]
                       in ("jax", "jaxlib", "raytracer_tpu"))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def probe():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", _PROBE % (MODULES,)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax_or_triton(probe, module):
    assert probe[module] == []
