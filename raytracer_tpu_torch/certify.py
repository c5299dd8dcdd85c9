"""Full-scale certification of the port's fast path against the reference
algorithm (port of ``scripts/certify_fullscale.py``).

Renders the reference's 8-sphere world at the BASELINE configuration
(512x512, 64 spp, 8 bounces) through two independent implementations:

  * the native C++ parity engine (``native.NativeWorld``: bit-identical to
    the oracle, the exact xorshift32 stream in raster order), and
  * the port's ``ray_trace`` on ``cuda`` (the CUDA kernel K1, the pcg3d
    counter sampler) with the reference's plane sign;

and certifies their agreement in u8 space: per-channel max |diff|, mean
|diff|, the share of pixels off by more than 8 and the PSNR.  The samplers
differ, so agreement is statistical (two unbiased 64-sample estimators):
PSNR > 30 dB and mean |diff| < 4, the script's bar.  The native image's
sha256 must equal ``CERTIFY.json``'s ``native_parity_sha256``, which this
module reads and never writes.

Run from the repository root:

    python -m raytracer_tpu_torch.certify [--out PATH]

The report (JSON) goes to ``--out``, by default
``chiprun_out/certify_torch.json``; the exit code is 0 only if every check
passes.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import native, ops
from .models import default_world_source
from .parser import parse_input
from .render import Options, ray_trace

__all__ = ["CONFIG", "PSNR_MIN_DB", "MEAN_ABS_MAX", "stats", "sha256",
           "certify", "main"]

ROOT = Path(__file__).resolve().parents[1]
CERTIFY_JSON = ROOT / "CERTIFY.json"
DEFAULT_OUT = ROOT / "chiprun_out" / "certify_torch.json"
CONFIG = {"width": 512, "height": 512, "spp": 64, "depth": 8,
          "scene": "default_world (reference world.txt)"}
PSNR_MIN_DB = 30.0
MEAN_ABS_MAX = 4.0


def stats(reference: np.ndarray, image: np.ndarray) -> dict:
    """u8 agreement of two RGBA8 framebuffers over their RGB channels, by
    the script's formulas: per-channel max |diff|, mean |diff|, the share
    of pixels whose largest channel differs by more than 8, PSNR (dB)."""
    a = np.asarray(reference)[..., :3].astype(np.int32)
    b = np.asarray(image)[..., :3].astype(np.int32)
    diff = np.abs(a - b)
    mse = float(np.mean((a - b).astype(np.float64) ** 2))
    return {
        "per_channel_max_diff_u8": [int(diff[..., c].max())
                                    for c in range(3)],
        "mean_abs_diff_u8": float(diff.mean()),
        "frac_pixels_diff_gt_8": float((diff.max(axis=-1) > 8).mean()),
        "psnr_db": float(10.0 * np.log10(255.0 ** 2 / max(mse, 1e-12))),
    }


def sha256(framebuffer: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(framebuffer).tobytes()).hexdigest()


def certify(device: str = "cuda") -> dict:
    """Render both images, compare them, and return the report; its
    ``"certified"`` is True only if every check passed.  The native render
    asks for every host core (``num_threads=0``), but the engine's parity
    mode is one xorshift32 stream and runs on one thread whatever it is
    asked; the report records that one thread.  ``fast_engine`` is the
    engine ``ops.resolve_dispatch`` picks for the fast render."""
    expected = json.loads(CERTIFY_JSON.read_text())
    if expected["config"] != CONFIG:
        raise ValueError(f"{CERTIFY_JSON} certifies {expected['config']}, "
                         f"not {CONFIG}")
    w, h, spp, depth = (CONFIG[k] for k in ("width", "height", "spp",
                                            "depth"))
    src = default_world_source()

    t0 = time.perf_counter()
    nat = native.NativeWorld(src).render(
        w, h, samples_per_pixel=spp, max_ray_bounces=depth, parity=True,
        num_threads=0)
    native_s = time.perf_counter() - t0

    world = parse_input(src)
    scene, cam = world.to_scene(), world.to_camera()
    opts = Options(samples_per_pixel=spp, max_ray_bounces=depth,
                   parity_plane_sign=True, device=device)
    engine, _ = ops.resolve_dispatch(scene, True, opts.engine, device,
                                     samples_per_pixel=spp, width=w,
                                     height=h)
    ray_trace(scene, cam, w, h, opts)             # builds the kernels once
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    fast, segments = ray_trace(scene, cam, w, h, opts)
    sync()
    fast_s = time.perf_counter() - t0

    report = {
        "config": CONFIG,
        "native_parity_sha256": sha256(nat),
        "expected_native_parity_sha256": expected["native_parity_sha256"],
        "fast_sha256": sha256(fast),
        "native_seconds": native_s,
        "native_threads": 1,
        "fast_seconds": fast_s,
        "fast_segments": int(segments),
        "device": (torch.cuda.get_device_name(torch.device(device))
                   if torch.device(device).type == "cuda" else device),
        "fast_engine": engine,
        **stats(nat, fast),
    }
    report["native_sha256_matches"] = (
        report["native_parity_sha256"]
        == report["expected_native_parity_sha256"])
    report["certified"] = bool(
        report["psnr_db"] > PSNR_MIN_DB
        and report["mean_abs_diff_u8"] < MEAN_ABS_MAX
        and report["native_sha256_matches"])
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracer_tpu_torch.certify",
        description="Certify the port's K1 against the native parity "
                    "engine at 512x512, 64 spp, depth 8.")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="report path (JSON); default %(default)s")
    args = ap.parse_args(argv)
    report = certify()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1) + "\n")
    print(json.dumps(report))
    if not report["certified"]:
        print(f"certify: FAILED (PSNR > {PSNR_MIN_DB} dB, mean |diff| < "
              f"{MEAN_ABS_MAX} and the native sha256 of {CERTIFY_JSON.name} "
              f"are required)", file=sys.stderr)
        return 1
    print("CERTIFIED")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
