#!/usr/bin/env python3
"""Smoke test of raytracer_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's forward render path through the hand-written CUDA
kernel K1, and its gradient pass through K1 and the backward kernel K5, and
fails (non-zero exit, no result line) if any phase fails:

  1. device: a CUDA GPU is required; prints its name and power limit;
  2. build: compiles csrc/*.cu with nvcc (first use) and prints the time;
  3. kernel vs plain version on the card, at 64x36, 4 spp, depth 8: the
     default world, the FFI world (triangles), the random sphere field with
     sphere clusters, the icosphere mesh with triangle clusters, and a
     banded render against the rows of a whole one.  Bar: equal segment
     counts and max|diff| <= 1e-5;
  4. the main path: ``cli.main`` at width 512, 64 spp, depth 8, checked
     by the launch counters (one K1 launch per row band, no K5) and
     against the plain version's framebuffer;
  5. throughput on the card: rays/s (traced segments / s) for the default
     world at 512x512, 64 spp, depth 8 and the random sphere field at
     512x512, 16 spp, depth 8, with K1's and the plain version's times;
  3b. K5 vs its plain version on the card, at 64x36, 2 spp, depth 4: the
     default world (every parameter class and the camera), the FFI world
     (parity sign), mesh_scene(2) with TriCull clusters (correct sign) and
     a banded call.  Bar: winner ids equal lane for lane and dsph, dtri,
     dcam within 1e-5 * max|ref| + 1e-7; and K1 + K5 against autograd
     through the wavefront renderer within 5e-3 * max|ref| + 1e-7;
  4b. the training path at full width: the bench's gradient configuration
     (default world 256x256, 8 spp, depth 4, target at seed 0, loss at
     seed 1, sphere_center + 0.02, sphere_radius, mat_color), value and
     gradient through ``grad.make_loss_fn(engine="auto")`` with exactly one
     K1 and one K5 launch; 5 Adam steps at lr 1e-2 through
     ``grad.make_train_step`` from that start, one K1 and one K5 launch
     each, finite losses (recorded: interior gradients do not descend on
     the geometry of this unmasked loss, in the JAX package either), then
     5 recovering mat_color from half of it on the same frame, one K1 and
     one K5 launch each: the loss stays finite and falls;
  5b. gradient throughput: paths/s of value-and-gradient and the Adam
     step's time; K1 and K5 at the training path's shapes (the start
     params, the loss's image cotangent) by CUDA events, each held against
     its plain version there with the bars of phases 3 and 3b, and the
     plain versions' times.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
SMALL = dict(width=64, height=36, samples_per_pixel=4, depth=8, seed=3)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA GPU (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def import_port():
    """Import the port from this checkout (never an installed copy)."""
    sys.path.insert(0, str(ROOT))
    import raytracer_tpu_torch as rtt
    if Path(rtt.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: raytracer_tpu_torch imported from "
                         f"{rtt.__file__}, not from {ROOT}")
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "raytracer_tpu")]
    if bad:
        raise SystemExit(f"chip_smoke: the port imported {bad}")
    return rtt


def phase_build() -> None:
    from raytracer_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    lib = build.load()
    log(f"build: {lib._name} built (nvcc) and loaded in "
        f"{time.perf_counter() - t0:.2f}s")


def compare(name, kernel, plain):
    (km, ks), (pm, ps) = kernel, plain
    if not torch.isfinite(km).all():
        raise SystemExit(f"{name}: kernel output is not finite")
    err = float((km - pm).abs().max())
    log(f"  {name}: max|diff| {err:.3e}, segments kernel {ks} plain {ps}")
    if ks != ps or not err <= TOL:
        raise SystemExit(f"{name}: kernel disagrees with the plain version "
                         f"(max|diff| {err}, segments {ks} vs {ps})")
    return err


def phase_kernel_vs_plain(rtt) -> float:
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    dev = torch.device("cuda")
    log(f"kernel vs plain version at {SMALL}")
    worlds = {
        "default world (spheres, parity sign)":
            (rtt.models.default_world().to_scene(),
             rtt.models.default_world().to_camera(), True),
        "FFI world (triangles, parity sign)":
            (rtt.models.ffi_example_world().to_scene(),
             rtt.models.ffi_example_world().to_camera(), True),
        "random spheres (sphere clusters)": (*rtt.models.random_spheres(),
                                             False),
        "mesh_scene(2) (triangle clusters)": (*rtt.models.mesh_scene(2),
                                              False),
    }
    worst = 0.0
    for name, (scene, cam, parity) in worlds.items():
        sph, tri, scl, tcl = ops.scene_tables(scene, parity, dev)
        if "clusters" in name and (scl if "sphere" in name else tcl) is None:
            raise SystemExit(f"{name}: expected cluster tables")
        kw = dict(SMALL, parity_plane_sign=parity, sph_clusters=scl,
                  tri_clusters=tcl)
        cv = tables.camera_vec(cam).to(dev)
        worst = max(worst, compare(
            name, wfc.render_linear_cuda(sph, tri, cv, **kw),
            wfc.render_linear_ref(sph, tri, cv, **kw)))

    # banded: each band's rows must be bitwise the whole render's rows
    scene, cam, parity = worlds["default world (spheres, parity sign)"]
    sph, tri, scl, tcl = ops.scene_tables(scene, parity, dev)
    cv = tables.camera_vec(cam).to(dev)
    kw = dict(SMALL, parity_plane_sign=parity)
    whole, _ = wfc.render_linear_cuda(sph, tri, cv, **kw)
    band = 8
    for r0 in range(0, SMALL["height"], band):
        k = wfc.render_linear_cuda(sph, tri, cv, shard_rows=band,
                                   row_offset=r0, **kw)
        p = wfc.render_linear_ref(sph, tri, cv, shard_rows=band,
                                  row_offset=r0, **kw)
        worst = max(worst, compare(f"band rows {r0}..{r0 + band - 1}", k, p))
        rows = min(band, SMALL["height"] - r0)
        if not torch.equal(k[0][:rows], whole[r0:r0 + rows]):
            raise SystemExit(f"band at row {r0} differs from the whole "
                             f"render's rows")
    log(f"  banded rows are bitwise the whole render's; worst max|diff| "
        f"{worst:.3e}")
    return worst


def phase_main_path(rtt) -> int:
    from raytracer_tpu_torch import cli, image
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    args = ["samples=64", "ray_depth=8", "width=512"]
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "image.ppm")
        wfc.LAUNCHES = wb.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main(args + [f"out={out}"])
        dt = time.perf_counter() - t0
        launches, k5_launches = wfc.LAUNCHES, wb.LAUNCHES
        fb = image.read_ppm(out)
    log(f"\nmain path: cli.main({args}) rc={rc} in {dt:.3f}s, K1 launches "
        f"{launches}, K5 launches {k5_launches}, framebuffer {fb.shape}")
    if rc != 0 or launches != 16 or k5_launches != 0:
        raise SystemExit(f"main path: rc {rc}, {launches} K1 launches "
                         f"(expected 16 row bands), {k5_launches} K5 "
                         f"launches (expected 0)")
    rgb = fb[..., :3].astype(np.int32)
    height = int(512 / 1.77778)                     # cli.py, main.rs:92
    if fb.shape != (height, 512, 4) or rgb.std() < 1.0:
        raise SystemExit(f"main path: bad framebuffer (shape {fb.shape}, "
                         f"std {rgb.std():.3f})")
    # the same frame's mean image through K1: finite everywhere, so no
    # pixel is a NaN zeroed by the u8 cast; black pixels are true zeros
    import math
    from raytracer_tpu_torch import ops
    scene = rtt.models.default_world().to_scene()
    cam = rtt.Camera.new_look_at((0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                                 (0.0, 1.0, 0.0), math.pi / 2.0, 1.77778)
    mean, _ = ops.render_linear_fast(
        scene, cam, width=512, height=height, samples_per_pixel=64,
        depth=8, device="cuda", seed=rtt.rng.DEFAULT_SEED)
    mean = mean.flip(0).cpu().numpy()
    black = np.argwhere(rgb.sum(-1) == 0)
    log(f"  mean image finite: {bool(np.isfinite(mean).all())}; "
        f"{len(black)} black pixels, mean there "
        f"{[mean[r, c].tolist() for r, c in black[:4]]}")
    if not np.isfinite(mean).all() or any(
            mean[r, c].max() * 255.999 ** 2 >= 1.0 for r, c in black):
        raise SystemExit("main path: NaN holes in the framebuffer")
    # the same frame through the plain version on the card
    ref, _ = rtt.ray_trace(scene, cam, 512, height, rtt.Options(
        samples_per_pixel=64, max_ray_bounces=8, engine="torch",
        device="cuda"))
    lsb = int(np.abs(ref.astype(np.int32) - fb.astype(np.int32)).max())
    log(f"  framebuffer vs plain version: max {lsb} LSB, "
        f"{int((ref != fb).any(-1).sum())} pixels differ")
    if lsb > 1:
        raise SystemExit(f"main path: framebuffer off by {lsb} LSB")
    return launches


def _median_seconds(fn, runs=5):
    fn(0)
    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(1 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def _event_ms(fn, runs=5):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_throughput(rtt, smi: str) -> dict:
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    dev = torch.device("cuda")
    world = rtt.models.default_world()
    configs = [("default world 512x512 64spp depth 8", world.to_scene(),
                world.to_camera(), 64),
               ("random spheres 512x512 16spp depth 8",
                *rtt.models.random_spheres(), 16)]
    result = {}
    log(f"\nthroughput on {smi}")
    for label, scene, cam, spp in configs:
        shape = dict(width=512, height=512, samples_per_pixel=spp, depth=8)

        def run(seed):
            return ops.render_linear_fast(scene, cam, device=dev, seed=seed,
                                          **shape)
        sec, (mean, segs) = _median_seconds(run)
        log(f"  {label}: {scene.num_spheres} spheres, {segs} segments, "
            f"median {sec * 1e3:.3f} ms -> {segs / sec:.6e} rays/s")
        parity = not scene.exact_planes
        sph, tri, scl, tcl = ops.scene_tables(scene, parity, dev)
        kw = dict(shape, seed=1, parity_plane_sign=parity, sph_clusters=scl,
                  tri_clusters=tcl)
        cv = tables.camera_vec(cam).to(dev)
        ms = _event_ms(lambda: wfc.render_linear_cuda(sph, tri, cv, **kw))
        kern, kseg = wfc.render_linear_cuda(sph, tri, cv, **kw)
        log(f"  {label}: K1 {ms:.3f} ms (CUDA events, median of 5)")
        # the plain version: the full config if a 1-spp run says it fits in
        # a minute, else only the 1-spp time
        t0 = time.perf_counter()
        wfc.render_linear_ref(sph, tri, cv, **dict(kw, samples_per_pixel=1))
        torch.cuda.synchronize()
        one = time.perf_counter() - t0
        plain_ms = None
        if one * spp < 60.0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain, pseg = wfc.render_linear_ref(sph, tri, cv, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            diff = (kern - plain).abs()
            log(f"  {label}: plain version {plain_ms:.3f} ms; K1 vs plain "
                f"max|diff| {float(diff.max()):.3e}, "
                f"{float((diff > 1e-3).any(-1).float().mean()):.6f} of "
                f"pixels over 1e-3, segments {kseg} vs {pseg}")
        else:
            log(f"  {label}: plain version not run at full size (1 spp took "
                f"{one:.3f} s)")
        result[label] = dict(rays_per_s=segs / sec, ms=ms, plain_ms=plain_ms)
    return result


# ---------------------------------------------------------------------------
# the gradient pass: K5
# ---------------------------------------------------------------------------

GRAD_SMALL = dict(width=64, height=36, samples_per_pixel=2, depth=4, seed=3)
GRAD_FULL = dict(width=256, height=256, samples_per_pixel=8, depth=4)
GRAD_FIELDS = ["sphere_center", "sphere_radius", "mat_color"]


def _grad_tables(scene, parity, dev):
    from raytracer_tpu_torch.ops import diff
    cull = None if parity else diff.build_tri_cull(scene)
    tri_cl = None if cull is None else (
        diff.tri_cluster_bounds(scene, cull),
        torch.from_numpy(cull.ranges).to(dev))
    return (diff.pack_spheres(scene).detach(),
            diff.pack_triangles(scene, perm=None if cull is None
                                else cull.perm).detach(), tri_cl)


def _within(name, got, want, rel) -> float:
    """max|got - want|, after checking finiteness and rel * max|want|."""
    if not torch.isfinite(got).all():
        raise SystemExit(f"{name}: not finite")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= rel * scale + 1e-7:
        raise SystemExit(f"{name}: max|diff| {err} over {rel} * {scale}")
    return err


def phase_grad_vs_plain(rtt) -> float:
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    dev = torch.device("cuda")
    log(f"\nK5 vs plain version at {GRAD_SMALL}")
    gen = torch.Generator(device=dev).manual_seed(0)
    worlds = {
        "default world (all materials, parity sign)":
            (rtt.models.default_world().to_scene(dev),
             rtt.models.default_world().to_camera(dev), True, None),
        "FFI world (triangles, parity sign)":
            (rtt.models.ffi_example_world().to_scene(dev),
             rtt.models.ffi_example_world().to_camera(dev), True, None),
        "mesh_scene(2) (TriCull clusters, correct sign)":
            (*(x.to(dev) for x in rtt.models.mesh_scene(2)), False, None),
        "default world, band rows 2, 5, 8, ..":
            (rtt.models.default_world().to_scene(dev),
             rtt.models.default_world().to_camera(dev), True,
             dict(shard_rows=12, row_offset=2, row_stride=3)),
    }
    worst = 0.0
    for name, (scene, cam, parity, band) in worlds.items():
        sph, tri, tri_cl = _grad_tables(scene, parity, dev)
        if "clusters" in name and tri_cl is None:
            raise SystemExit(f"{name}: expected cluster tables")
        band = band or {}
        rows = band.get("shard_rows", GRAD_SMALL["height"])
        g = torch.randn(rows, GRAD_SMALL["width"], 3, device=dev,
                        generator=gen)
        cv = tables.camera_vec(cam)
        kw = dict(GRAD_SMALL, parity_plane_sign=parity, tri_clusters=tri_cl,
                  **band)
        kslab, kcam = wb.grad_slab_cuda(sph, tri, g, cv, **kw)
        torch.cuda.synchronize()
        pslab, pcam = wb.grad_slab_ref(sph, tri, g, cv, **kw)
        kids, pids = kslab[:, :, wb.GP_WIN], pslab[:, :, wb.GP_WIN]
        if not torch.equal(kids, pids) or not (pids >= 0).any():
            raise SystemExit(f"{name}: K5 winner ids differ from the plain "
                             f"version's ({int((kids != pids).sum())} lanes)")
        lane_err = max(float((kslab - pslab).abs().max()),
                       float((kcam - pcam).abs().max()))
        S, T = sph.shape[1], tri.shape[1]
        errs = [_within(f"{name} {out}", a, b, TOL) for out, a, b in zip(
            ("dsph", "dtri", "dcam"), wb.reduce_slab(kslab, kcam, S, T),
            wb.reduce_slab(pslab, pcam, S, T))]
        worst = max(worst, *errs)
        log(f"  {name}: winner ids equal, per-lane max|diff| {lane_err:.3e}; "
            f"dsph/dtri/dcam max|diff| "
            f"{' / '.join(f'{e:.3e}' for e in errs)}")

    # K1 + K5 against autograd through the wavefront renderer, every
    # parameter class and the camera
    from raytracer_tpu_torch import grad
    from raytracer_tpu_torch.ops import diff
    w = rtt.models.default_world()
    scene, cam = w.to_scene(dev), w.to_camera(dev)
    kw = dict(GRAD_SMALL, parity_plane_sign=True)
    with torch.no_grad():
        target, _ = rtt.render_linear(scene, cam, **dict(kw, seed=9))
    fields = ["sphere_center", "sphere_radius", "mat_color", "mat_fuzz",
              "mat_ir"]
    cam_fields = ("origin", "lower_left_corner", "horizontal", "vertical")
    start = grad.extract_params(scene, fields)
    start["sphere_center"] = start["sphere_center"] + 0.02
    grads = {}
    for engine in ("kernels", "autograd"):
        p = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        c = rtt.Camera(*(getattr(cam, f).clone().requires_grad_(True)
                         for f in cam_fields))
        s = grad.apply_params(scene, p)
        img = (diff.render_linear_diff(s, c, **kw) if engine == "kernels"
               else rtt.render_linear(s, c, **kw)[0])
        grad.image_loss(img, target).backward()
        grads[engine] = {**{k: v.grad for k, v in p.items()},
                         **{f: getattr(c, f).grad for f in cam_fields}}
    for k, want in grads["autograd"].items():
        err = _within(f"K1 + K5 vs autograd, {k}", grads["kernels"][k], want,
                      5e-3)
        log(f"  K1 + K5 vs autograd, {k}: max|diff| {err:.3e} "
            f"(scale {float(want.abs().max()):.3e})")
    return worst


def _bench_grad(rtt):
    """The bench's gradient configuration on the card: (scene, camera,
    target, loss_fn, start params)."""
    from raytracer_tpu_torch import grad
    dev = torch.device("cuda")
    w = rtt.models.default_world()
    scene, cam = w.to_scene(dev), w.to_camera(dev)
    with torch.no_grad():
        target, _ = rtt.render_linear(scene, cam, seed=0, **GRAD_FULL)
    loss_fn = grad.make_loss_fn(scene, cam, target, seed=1, engine="auto",
                                **GRAD_FULL)
    params = grad.extract_params(scene, GRAD_FIELDS)
    params["sphere_center"] = params["sphere_center"] + 0.02
    return scene, cam, target, loss_fn, params


def _adam_steps(loss_fn, start, n=5):
    """n Adam steps at lr 1e-2 through make_train_step: (losses before each
    step, loss after the last, K1 and K5 launches of the steps)."""
    from raytracer_tpu_torch import grad
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    step = grad.make_train_step(loss_fn, torch.optim.Adam(params.values(),
                                                          lr=1e-2))
    wfc.LAUNCHES = wb.LAUNCHES = 0
    losses = [float(step(params)) for _ in range(n)]
    torch.cuda.synchronize()
    launches = (wfc.LAUNCHES, wb.LAUNCHES)
    with torch.no_grad():
        final = float(loss_fn(params))
    return losses, final, launches


def phase_train(rtt) -> dict:
    from raytracer_tpu_torch import grad
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    log(f"\ntraining path: default world {GRAD_FULL}, target seed 0, loss "
        f"seed 1, {GRAD_FIELDS}, sphere_center + 0.02")
    scene, cam, target, loss_fn, start = _bench_grad(rtt)
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    wfc.LAUNCHES = wb.LAUNCHES = 0
    loss0 = loss_fn(params)
    loss0.backward()
    torch.cuda.synchronize()
    counts = (wfc.LAUNCHES, wb.LAUNCHES)
    log(f"  value and gradient: loss {float(loss0.detach()):.9e}, K1 "
        f"launches {counts[0]}, K5 launches {counts[1]}")
    if counts != (1, 1):
        raise SystemExit(f"training path: K1/K5 launches {counts}, "
                         f"expected (1, 1)")
    for k, v in params.items():
        if v.grad is None or not torch.isfinite(v.grad).all() \
                or not v.grad.any():
            raise SystemExit(f"training path: bad gradient for {k}")
    # Interior gradients (no silhouette terms) do not descend on this
    # unmasked loss for the geometry, in the JAX package either: the losses
    # are recorded, the launches and finiteness required
    losses, final, bench_launches = _adam_steps(loss_fn, start)
    log(f"  5 Adam steps at lr 1e-2 from the bench start: losses {losses}, "
        f"after: {final:.9e}; K1/K5 launches {bench_launches}")
    if bench_launches != (5, 5) or not all(np.isfinite(losses + [final])):
        raise SystemExit(f"training path: K1/K5 launches {bench_launches} "
                         f"over 5 steps, losses {losses + [final]}")
    # the fit the interior gradient supports: albedo recovery from half the
    # albedo (test_fit_recovers_albedo) on the same frame
    albedo = {"mat_color": grad.extract_params(scene, ["mat_color"])[
        "mat_color"] * 0.5}
    albedo_loss = grad.make_loss_fn(scene, cam, target, seed=1,
                                    engine="auto", **GRAD_FULL)
    losses, final, launches = _adam_steps(albedo_loss, albedo)
    log(f"  5 Adam steps at lr 1e-2 recovering mat_color from x0.5: losses "
        f"{losses}, after: {final:.9e}; K1/K5 launches {launches}")
    if launches != (5, 5):
        raise SystemExit(f"training path: K1/K5 launches {launches} over 5 "
                         f"steps")
    if not all(np.isfinite(losses + [final])) or not final < losses[0]:
        raise SystemExit(f"training path: loss did not fall "
                         f"({losses[0]} -> {final})")
    return dict(k1_launches=counts[0] + bench_launches[0] + launches[0],
                k5_launches=counts[1] + bench_launches[1] + launches[1],
                loss0=losses[0], loss5=final)


def phase_grad_throughput(rtt, smi: str) -> dict:
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    from raytracer_tpu_torch import grad
    dev = torch.device("cuda")
    scene, cam, target, loss_fn, start = _bench_grad(rtt)
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}

    def value_and_grad(_):
        for v in params.values():
            v.grad = None
        loss = loss_fn(params)
        loss.backward()
        return loss

    sec, _ = _median_seconds(value_and_grad)
    paths = GRAD_FULL["width"] * GRAD_FULL["height"] * \
        GRAD_FULL["samples_per_pixel"]
    log(f"\ngradient throughput on {smi}")
    log(f"  value and gradient, default world {GRAD_FULL}: median "
        f"{sec * 1e3:.3f} ms -> {paths / sec:.6e} paths/s")
    opt = torch.optim.Adam(params.values(), lr=1e-2)
    step = grad.make_train_step(loss_fn, opt)
    step_sec, _ = _median_seconds(lambda _: step(params))
    log(f"  one Adam train step (value, gradient, update): median "
        f"{step_sec * 1e3:.3f} ms")

    # K1 and K5 alone at the shapes the training path gives them: the
    # start params' tables (spheres flat) and the loss's image cotangent
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    s = grad.apply_params(scene, start)
    sph, tri, _ = _grad_tables(s, True, dev)
    cv = tables.camera_vec(cam)
    kw = dict(GRAD_FULL, seed=1, parity_plane_sign=True)
    k1_ms = _event_ms(lambda: wfc.render_linear_cuda(sph, tri, cv, **kw))
    img, kseg = wfc.render_linear_cuda(sph, tri, cv, **kw)
    k1_err = compare(f"K1 vs plain at {GRAD_FULL}", (img, kseg),
                     wfc.render_linear_ref(sph, tri, cv, **kw))
    g = (2.0 * (img - target) / img.numel()).contiguous()
    ms = _event_ms(lambda: wb.grad_slab_cuda(sph, tri, g, cv, **kw))
    kslab, kcam = wb.grad_slab_cuda(sph, tri, g, cv, **kw)
    red_ms = _event_ms(lambda: wb.reduce_slab(kslab, kcam, sph.shape[1],
                                              tri.shape[1]))
    log(f"  K1 forward {k1_ms:.3f} ms, K5 {ms:.3f} ms, winner reduction "
        f"{red_ms:.3f} ms (CUDA events, median of 5)")
    # K5's plain version at the same shape, timed and held against K5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pslab, pcam = wb.grad_slab_ref(sph, tri, g, cv, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kids, pids = kslab[:, :, wb.GP_WIN], pslab[:, :, wb.GP_WIN]
    if not torch.equal(kids, pids) or not (pids >= 0).any():
        raise SystemExit(f"K5 at {GRAD_FULL}: winner ids differ from the "
                         f"plain version's ({int((kids != pids).sum())} "
                         f"lanes)")
    lane_err = max(float((kslab - pslab).abs().max()),
                   float((kcam - pcam).abs().max()))
    S, T = sph.shape[1], tri.shape[1]
    errs = [_within(f"K5 at {GRAD_FULL} {out}", a, b, TOL) for out, a, b in
            zip(("dsph", "dtri", "dcam"), wb.reduce_slab(kslab, kcam, S, T),
                wb.reduce_slab(pslab, pcam, S, T))]
    log(f"  K5 plain version {plain_ms:.3f} ms; K5 vs plain: winner ids "
        f"equal, per-lane max|diff| {lane_err:.3e}, dsph/dtri/dcam "
        f"max|diff| {' / '.join(f'{e:.3e}' for e in errs)}")
    return dict(paths_per_s=paths / sec, ms=ms, plain_ms=plain_ms,
                k1_err=k1_err, k5_err=max(errs))


def main() -> int:
    smi = phase_device()
    rtt = import_port()
    phase_build()
    max_err = phase_kernel_vs_plain(rtt)
    k5_err = phase_grad_vs_plain(rtt)
    launches = phase_main_path(rtt)
    train = phase_train(rtt)
    perf = phase_throughput(rtt, smi)
    gperf = phase_grad_throughput(rtt, smi)
    head = perf["default world 512x512 64spp depth 8"]
    print(json.dumps({"kernels": [{
        "name": "wavefront_render (K1)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront.py:1032",
        "launches": launches + train["k1_launches"],
        "max_abs_err": max(max_err, gperf["k1_err"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"]}, {
        "name": "wavefront_grad (K5)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront_bwd.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront_bwd.py:964",
        "launches": train["k5_launches"],
        "max_abs_err": max(k5_err, gperf["k5_err"]),
        "ms": gperf["ms"], "plain_ms": gperf["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
