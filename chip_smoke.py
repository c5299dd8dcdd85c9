#!/usr/bin/env python3
"""Smoke test of raytracer_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's forward render path through the hand-written CUDA
kernel K1 (and the CLI's file output through the native C++ writer), its
gradient pass through K1 and the backward kernel K5, its triangle-mesh
paths through the binned per-bounce kernel K3 and the
streamed big-mesh kernel K4, the big-mesh gradient pass through K2 and
K5s (K1 and K5 with the two-level leaf walk), the big-mesh frames past
128 spp or 2^24 rays through the sorted per-bounce kernel K6, K1's
bfloat16 sphere stage K1-lowp, the silhouette gradients and their fits,
the reference-parity path (the native C++ engine, the oracle, the
sequential parity renderer, the full-scale certification) and the browser
viewer on the card, and fails (non-zero exit, no result line) if any phase
fails:

  1. device: a CUDA GPU is required; prints its name and power limit;
  2. build: compiles csrc/*.cu with nvcc (first use) and prints the time
     and ptxas's registers, stack and spills of every kernel instance (K1,
     K1-lowp and K5 one for each plane sign and triangle walk: none, flat,
     one-level leaves);
  3. K1 vs its plain version on the card, at 64x36, 4 spp, depth 8: the
     default world, the FFI world (triangles), the random sphere field with
     sphere clusters, the icosphere mesh with triangle clusters, and a
     banded render against the rows of a whole one.  Bar: equal segment
     counts and max|diff| <= 1e-5;
  3b. K5 vs its plain version on the card, at 64x36, 2 spp, depth 4: the
     default world (every parameter class and the camera), the FFI world
     (parity sign), mesh_scene(2) with TriCull clusters (correct sign) and
     a banded call.  Bar: winner ids equal lane for lane and dsph, dtri,
     dcam within 1e-5 * max|ref| + 1e-7; and K1 + K5 against autograd
     through the wavefront renderer within 5e-3 * max|ref| + 1e-7;
  3c. K4 and K3 vs their plain versions at 64x36, depth 4 (4 spp; 2 on the
     164k scene) on mesh-1292, OBJ-10k and the bench's 164k-triangle
     scene, with the host time of each table build; K3 with the supertop
     scan switched, node_exit off and generous caps bitwise equal to the
     default run, tiny caps tripping the overflow guard; a K4 band against
     the rows of a whole K4 render.  Bar: equal segments, and max|diff|
     <= 1e-5 except on at most 0.01% of the pixels (exact triangle ties),
     each reported; K4's bar is bitwise (max|diff| 0, differing pixels
     reported);
  3d. K2 and K5s (with their sub-leaf boxes) vs their plain versions at
     64x36, 2 spp, depth 4, correct sign: OBJ-10k in the 128-leaf topology
     (forced: 128 leaves, 8 tops) and the 164k scene under its own rule
     (2048 leaves, 128 tops).
     Bars: K2 as in 3c; K5s winner ids equal lane for lane and dsph, dtri,
     dcam within 1e-5 * max|ref| + 1e-7; and K2 / K5s bitwise equal to
     K1 / K5 over the packed table and the same leaves (image, segments,
     slab, camera lanes);
  3e. K6 vs its plain version at 64x36, depth 4 (4 spp; 2 on 164k) on the
     three meshes and a 37x21 mesh-1292 frame at 3 spp (Morton padding),
     node_exit off bitwise on; bar as 3c;
  3f. K1-lowp vs its plain version at 64x36, 4 spp, depth 8, parity sign,
     on the default world, the two-sphere unit scene and a three-sphere
     scene (an odd count: the packed table's padding sphere): bitwise;
  4. the main path: ``cli.main`` at width 512, 64 spp, depth 8, checked
     by the launch counters (one K1 launch per row band, no K5) and
     against the plain version's framebuffer; K1's 16 bands replayed, with
     their bound;
  4b. the training path at full width: the bench's gradient configuration
     (default world 256x256, 8 spp, depth 4, target at seed 0, loss at
     seed 1, sphere_center + 0.02, sphere_radius, mat_color), value and
     gradient through ``grad.make_loss_fn(engine="auto")`` with exactly one
     K1 and one K5 launch; 5 Adam steps at lr 1e-2 through
     ``grad.make_train_step`` from that start, one K1 and one K5 launch
     each, finite losses (recorded: interior gradients alone do not
     descend on the geometry of this unmasked loss, in the JAX package
     either; phase 4g adds the boundary terms), then
     5 recovering mat_color from half of it on the same frame, one K1 and
     one K5 launch each: the loss stays finite and falls;
  4c. the mesh main paths at full width: ``api.RenderSession`` over
     OBJ-10k at 512x288, 4 spp, depth 4 resolves to ``cuda_binned``; its
     first frame (the probe) launches K3 depth times and nothing else; the
     same camera again runs capped (K3 only, no new probe), bitwise the
     uncapped K3 frame and the probe's framebuffer, and is held against
     the plain version under the same caps; a moved camera renders a new
     probe.  ``cli.main`` with ``obj=`` (the OBJ-10k triangles written
     with ``dump_obj``), width 512, 16 spp, depth 8 launches K4 once per
     band and nothing else; that frame through K4 and through its plain
     version at the CLI's shape and 16 bands, bitwise equal (the plain
     bands' walks counted for K4's bound), the K4 one bitwise the CLI's
     framebuffer.  Both framebuffers within 1 LSB of K1's render of the
     same scene on 99.99% of pixels;
  4d. the mesh gradient path at full width, as bench.py:184-222 sets it
     up (target from ``render_linear_fast`` at seed 0, loss at seed 1,
     correct sign, ``make_loss_fn(engine="pallas")``): OBJ-10k at 256x256,
     8 spp, depth 4 (tri_v0, mat_color) launches exactly one K1 and one K5
     per value and gradient; the 164k scene at 256x256, 4 spp, depth 4
     (tri_v0) exactly one K2 and one K5s; gradients finite and not all
     zero; then 3 Adam steps at lr 1e-2 recovering mat_color from half of
     it on each, one launch pair per step, and the loss falls;
  4e. the sorted engine's main paths at full width: (A) an
     ``api.RenderSession`` over OBJ-10k at 512x512, 256 spp, depth 4
     resolves to ``cuda_sorted`` and its frame launches K6 4 times and
     nothing else; (B) ``ops.render_linear_fast`` on the 164k scene at
     1024x1024, 32 spp, depth 4 (33.5M rays, past 2^24) resolves to
     ``cuda_sorted`` and launches K6 4 times and nothing else.  Each
     framebuffer within 1 LSB of K1's on 99.99% of pixels, segments within
     0.01% of K1's, peak device memory printed;
  4f. the lowp study's frame (default world 512x512, 64 spp, depth 8,
     parity sign) through ``render_linear_cuda(lowp=True)``: one K1-lowp
     launch and nothing else;
  4g. the silhouette path (``grad/silhouette.py``; no kernel lies on it,
     as no Pallas kernel lies on the JAX package's): on the default world
     (primary, mirror and glass estimators) and the FFI world (and the
     triangle and mirrored-edge estimators) at 64x36, 2 spp, depth 4,
     ``value_and_grad_with_silhouette(device="cuda")`` against
     ``device="cpu"``: every grad leaf and each estimator's outputs within
     1e-3 * max|cpu| + 1e-6, the loss within 1e-5 relative, identical edge
     selections; 5 ``make_silhouette_train_step`` steps at the training
     path's configuration (sphere_center + 0.02 and sphere_radius, Adam lr
     1e-2): each step's ms (host clock ending in a sync) split into the
     interior value-and-gradient and each estimator, peak device memory,
     finite losses and 0 kernel launches; ``scripts/obj_silhouette_fit.py``
     on OBJ-10k (64x64, 2 spp, depth 2, 30 Adam steps on a rigid offset)
     with the script's two 0.6x bars, ms a step and peak memory; and
     ``fit(silhouette=True, device="cuda")`` as
     ``test_silhouette_fit_recovers_large_offset`` sets it up, with its
     bars;
  5. throughput on the card: rays/s (traced segments / s) for the default
     world at 512x512, 64 spp, depth 8 and the random sphere field at
     512x512, 16 spp, depth 8, with K1's and the plain version's times;
  5b. gradient throughput: paths/s of value-and-gradient and the Adam
     step's time; K1 and K5 at the training path's shapes (the start
     params, the loss's image cotangent) by CUDA events, each held against
     its plain version there with the bars of phases 3 and 3b, and the
     plain versions' times;
  5c. mesh throughput: rays/s through ``render_linear_fast`` (warm capped
     K3 frames) for mesh-1292, OBJ-10k and 164k at 512x512, 4 spp, depth
     4, with no overflowed frame, K1's rays/s on the same frames, K3's
     per-pass and regroup times, each capped frame bitwise the uncapped
     one; K3 and K4 against their plain versions at OBJ-10k 512x288, 4 spp,
     depth 4 (K4 bitwise), with their times and bounds (the node and
     triangle tests counted from the plain versions' rays and final hits);
     K4 at the CLI's frame: one launch, the 16 bands, each band, the bound
     per band, and both again without sub-leaf bounds;
  5d. mesh gradient throughput: paths/s of both value-and-gradient passes
     (median of 5, host clock ending in a sync); K2 and K5s (164k) and K1
     and K5 (OBJ-10k) by CUDA events at the passes' own tables and image
     cotangents, K2 and K5s held bitwise against K1 and K5 over the same
     leaves there (image, segments, slab and winner ids, camera lanes) and
     against their plain versions, with their times and bounds (top, leaf
     and sub-leaf box and triangle tests counted from the plain version's
     rays, and as counted before sub-leaves); the winner reduction, the
     host glue and the peak device memory of each pass; at OBJ-10k K1
     held against its plain version with the triangle stage vectorised
     (all columns at once), the one-level walk's leaf box and triangle
     tests counted from its rays, and K1's and K5's bounds; the walk
     crossover: the 164k pass one-level in 64-triangle leaves against the
     two-level walk, OBJ-10k one-level against the forced two-level walk
     (K2 and K5s held as at 164k);
  5e. sorted throughput: rays/s of (A) and (B) (median of 3) beside K1's
     on the same frames, each under torch.profiler once, K6's bounces,
     sorts + gathers (of the live prefix) and image assembly by CUDA
     events, the slots each bounce launched and the rays live at its
     start; the crossover K6 vs K1 on mesh-1292 at 1024x1024, 32 spp,
     depth 4 (SORTED_MIN_TRIS); K6 vs K3 at 512x512, 4 spp, depth 4 on
     the three meshes; K6 vs its plain version at (A) (67.1M rays, past
     2^24; bitwise), with both versions' bounce times and K6's bound
     there; K1-lowp vs K1 at the lowp study's frame with both times, the
     plain version's (held bitwise) and PSNR against float32;
  6a. native: the C++ library built by the host compiler (built once,
     before phase 4, whose CLI writes through it: its build time and the
     compiler's version line); phase 4's framebuffer written by the native
     writer and by the Python formatter (bytes equal, both times); and
     ``cli.main`` as phase 4 runs it, with the native writer and with the
     formatter (the library made unavailable), in turns, files equal;
  6b. the sequential parity renderer on the card
     (``ray_trace_parity(device="cuda")``, its per-sample step replayed as
     a CUDA graph): the default world at 48x27, 2 spp, depth 8 and the FFI
     world at 32x18, 2 spp, depth 4, each bitwise ``NativeWorld.render``
     and the oracle, with samples/s; ``cli.main`` with ``parity=1`` at
     width 64, 1 spp, depth 2 on the card, its PPM bitwise
     ``ray_trace_parity`` on the CLI's scene and camera;
  6c. ``certify.certify()`` at full size (512x512, 64 spp, depth 8):
     native parity against the port's K1 (the resolved engine ``cuda``,
     two K1 launches -- warm-up and timed -- and nothing else); PSNR > 30
     dB, mean |du8| < 4 and the native sha256 equal to ``CERTIFY.json``'s;
     its report on one line
     beside the card's name and power limit (also written to
     ``chiprun_out/certify_torch.json``);
  6d. ``httpviewer.make_server`` on 127.0.0.1 in a thread over a
     progressive default-world ``RenderSession`` on ``cuda`` as ``serve``
     builds it (400x224, 16 spp, depth 8, max_samples 48): ``GET /``, three
     ``/frame.png`` polls (X-Samples 16, 32, 48, each launching K1 once and
     nothing else, counters zeroed before each request and read after),
     ``POST /move``, a poll back at 16, ``GET /camera``, the ms of each;
     the first PNG bitwise a fresh identical session's ``frame()``, and
     ``viewer.framebuffer_to_ansi`` of it; then a mesh session over the
     5120-triangle icosphere resolving to ``cuda_binned``, whose polls
     launch K3 and no other kernel.

After the phases a line sums each of the eight kernels' device time over
this run's main-path launches (launches x the time at their shapes; K1's
16 CLI bands each replayed).  The line before the last is a JSON object
describing each kernel; the last line is ``{"ok": true, "device":
{...}}``.

Old against new, in one call on one card (the kernel redesigns are
measured so until the port has a benchmark): ``python3 chip_smoke.py
--times TREE OUT.json`` times K4 and K6 on their main paths (K4 at the
CLI's obj= frame, one launch and 16 bands, the same shape with OBJ-10k's
own camera, and OBJ-10k 512x288; the (A) and (B) frames with their
bounces, sorts + gathers, assembly, slots and a hash of each framebuffer),
K1 at the headline frame and at the CLI's 16 bands (``cli.main``'s own
calls, each replayed; the bands held bitwise against one whole-frame call,
the framebuffer hashed), K1-lowp at the lowp study's frame, K1 and K5 at
the default world's and OBJ-10k's gradient passes, the 164k gradient pass
with its K2 and K5s (their calls in each pass recorded and replayed;
hashes of every image and its segments, slab with zeros as +0, and camera
lanes), and K3 at its main path's frames (phase 5c's capped frames of the
three meshes and the API session's OBJ-10k frame, with each frame's
passes and regroups by CUDA events and a hash of each image and its
segments), for the port in the checkout TREE, with its ptxas figures,
using only entry points every
version of the port has; run it on an older checkout (``git archive``
unpacked under ``build/``) and on this one in turns, then ``python3
chip_smoke.py --compare-times OUT...`` prints them side by side and fails
unless every run's outputs are bitwise alike.  ``python3 chip_smoke.py
--parts OUT.json [PART ...]`` measures what each part of the K4 and K6
("k4k6"), K2 and K5s ("k2"), K1 and K5 ("k1"), K3 ("k3") and K1-lowp
("lowp") designs buys on this checkout, all parts unless some are named
(copies of csrc/ built with a part switched off: the staged tiles;
without sub-leaf bounds; K6's live prefix; K5s's register cap; K1's and
K5's runs of one sample, the one-thread-a-pixel layout; K3's dead-warp
skip; K1-lowp's packed stage against per-operation conversions and
scalar bfloat16).
"""

from __future__ import annotations

import hashlib
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


def import_port(root=ROOT):
    """Import the port from the checkout at ``root`` (never an installed
    copy)."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    import raytracer_tpu_torch as rtt
    if Path(rtt.__file__).resolve().parent.parent != root:
        raise SystemExit(f"chip_smoke: raytracer_tpu_torch imported from "
                         f"{rtt.__file__}, not from {root}")
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "raytracer_tpu")]
    if bad:
        raise SystemExit(f"chip_smoke: the port imported {bad}")
    return rtt


def phase_build() -> dict:
    """Build and load the kernels; print ptxas's registers, stack and
    spills of every kernel instance from the build's ptxas.log."""
    from raytracer_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    lib = build.load()
    log(f"build: {lib._name} built (nvcc) and loaded in "
        f"{time.perf_counter() - t0:.2f}s")
    return ptxas_report(Path(lib._name).parent / "ptxas.log")


# the kernel instances whose ptxas figures every run prints: a fragment of
# each mangled name (template flags PARITY, LOWP and K1's and K5's triangle
# walk: 0 none, 1 flat, 2 one-level leaves; a name's length prefix keeps
# the fragments apart)
PTXAS_KERNELS = {
    "K1 spheres only (headline)": "wavefront_kernelILb1ELb0ELi0E",
    "K1 spheres only, correct sign": "wavefront_kernelILb0ELb0ELi0E",
    "K1 flat triangles": "wavefront_kernelILb0ELb0ELi1E",
    "K1 flat triangles, parity sign": "wavefront_kernelILb1ELb0ELi1E",
    "K1 leaves": "wavefront_kernelILb0ELb0ELi2E",
    "K1-lowp spheres only (study)": "wavefront_kernelILb1ELb1ELi0E",
    "K1-lowp spheres only, correct sign": "wavefront_kernelILb0ELb1ELi0E",
    "K1-lowp flat triangles": "wavefront_kernelILb0ELb1ELi1E",
    "K1-lowp flat triangles, parity sign": "wavefront_kernelILb1ELb1ELi1E",
    "K1-lowp leaves": "wavefront_kernelILb0ELb1ELi2E",
    "K2": "16two_level_kernel",
    "K3 primary": "binned_pass_kernelILb1E",
    "K3 later passes": "binned_pass_kernelILb0E",
    "K4": "13stream_kernel",
    "K5 spheres only (default-world pass)": "wavefront_grad_kernelILb1ELi0E",
    "K5 spheres only, correct sign": "wavefront_grad_kernelILb0ELi0E",
    "K5 flat triangles": "wavefront_grad_kernelILb0ELi1E",
    "K5 flat triangles, parity sign": "wavefront_grad_kernelILb1ELi1E",
    "K5 leaves (OBJ-10k pass)": "wavefront_grad_kernelILb0ELi2E",
    "K5s": "21two_level_grad_kernel",
    "K6 primary": "sorted_bounce_kernelILb1E",
    "K6 later bounces": "sorted_bounce_kernelILb0E"}
# the instances of the one-thread-a-pixel K1 and K5 (before their walk was
# a template flag), which ``--times`` reports for an older checkout
PTXAS_PER_PIXEL = {"K1 (per pixel)": "wavefront_kernelILb0ELb0EE",
                   "K1 parity sign (per pixel)": "wavefront_kernelILb1ELb0EE",
                   "K1-lowp (per pixel)": "wavefront_kernelILb1ELb1EE",
                   "K1-lowp correct sign (per pixel)":
                       "wavefront_kernelILb0ELb1EE",
                   "K5 (per pixel)": "wavefront_grad_kernelILb0EE",
                   "K5 parity sign (per pixel)":
                       "wavefront_grad_kernelILb1EE"}


def ptxas_report(path, required=True) -> dict:
    """{kernel: (registers, stack bytes, spill store bytes)} from a
    ``-Xptxas -v`` log, printed; with ``required`` every instance of
    PTXAS_KERNELS must be there, else the instances of an older checkout's
    build are reported too (K2 and K5s were once launches of K1's and K5's
    kernels, which had no walk flag)."""
    import re
    lines = Path(path).read_text().splitlines() if Path(path).exists() \
        else []
    out = {}
    names = PTXAS_KERNELS if required else {**PTXAS_KERNELS,
                                            **PTXAS_PER_PIXEL}
    for name, frag in names.items():
        for i, line in enumerate(lines):
            if "Compiling entry" in line and frag in line:
                block = " ".join(lines[i:i + 4])
                regs = re.search(r"Used (\d+) registers", block)
                stack = re.search(r"(\d+) bytes stack frame", block)
                spill = re.search(r"(\d+) bytes spill stores", block)
                out[name] = tuple(int(m.group(1)) if m else -1
                                  for m in (regs, stack, spill))
                break
    log("  ptxas: " + "; ".join(
        f"{k} {r} registers, {st} B stack, {sp} B spilled"
        for k, (r, st, sp) in out.items()))
    if required and len(out) != len(PTXAS_KERNELS):
        raise SystemExit(f"ptxas.log lacks {set(PTXAS_KERNELS) - set(out)}")
    return out


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
    args = CLI_ARGS
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "image.ppm")
        wfc.LAUNCHES = wb.LAUNCHES = 0
        with _Recorder(wfc, "render_linear_cuda") as bands:
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
    band_ms = bands.replay_ms(runs=5)
    # the bound of each band: the spheres' tests and the shading of its
    # segments (the default world: spheres only), its tables and image
    n_sph = scene.num_spheres
    per = [bound(segs * (n_sph * FLOPS_SPHERE + FLOPS_SHADE),
                 nbytes(*a[:3], mean)) for a, _, (mean, segs) in bands.calls]
    b = sum(x[0] for x in per)
    log(f"  K1 over the CLI's 16 bands (each band's call replayed, CUDA "
        f"events): {sum(band_ms):.3f} ms, {min(band_ms):.3f} to "
        f"{max(band_ms):.3f} ms a band; bound {b:.4f} ms by "
        f"{per[0][1]} ({100 * b / sum(band_ms):.2f}%)")
    return launches, sum(band_ms), (b, per[0][1]), fb


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
        b = bound(kseg * (sph.shape[1] * FLOPS_SPHERE + FLOPS_SHADE),
                  nbytes(sph, tri, cv, kern))
        log(f"  {label}: K1 bound {b[0]:.4f} ms by {b[1]}")
        result[label] = dict(rays_per_s=segs / sec, ms=ms, plain_ms=plain_ms,
                             bound=b)
    return result


# ---------------------------------------------------------------------------
# the gradient pass: K5
# ---------------------------------------------------------------------------

GRAD_SMALL = dict(width=64, height=36, samples_per_pixel=2, depth=4, seed=3)
GRAD_FULL = dict(width=256, height=256, samples_per_pixel=8, depth=4)
GRAD_FIELDS = ["sphere_center", "sphere_radius", "mat_color"]


def _grad_tables(scene, parity):
    from raytracer_tpu_torch.ops import diff
    with torch.no_grad():
        t = diff.walk_tables(scene, None if parity
                             else diff.build_tri_cull(scene))
    return t["sph"], t["packed"], t["clusters"]


def _within(name, got, want, rel) -> float:
    """max|got - want|, after checking finiteness and rel * max|want|."""
    if not torch.isfinite(got).all():
        raise SystemExit(f"{name}: not finite")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err <= rel * scale + 1e-7:
        raise SystemExit(f"{name}: max|diff| {err} over {rel} * {scale}")
    return err


def _hold_k5(name, kern, plain, S, T) -> float:
    """K5 / K5s outputs (slab, camera lanes) against the plain version's:
    winner ids equal lane for lane (some lane hits), the reduced dsph, dtri
    and dcam within TOL * max|ref| + 1e-7.  Returns the worst of those."""
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    kids, pids = kern[0][:, :, wb.GP_WIN], plain[0][:, :, wb.GP_WIN]
    if not torch.equal(kids, pids) or not (pids >= 0).any():
        raise SystemExit(f"{name}: winner ids differ from the plain "
                         f"version's ({int((kids != pids).sum())} lanes)")
    lane_err = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
    errs = [_within(f"{name} {out}", a, b, TOL) for out, a, b in zip(
        ("dsph", "dtri", "dcam"), wb.reduce_slab(*kern, S, T),
        wb.reduce_slab(*plain, S, T))]
    log(f"  {name}: winner ids equal, per-lane max|diff| {lane_err:.3e}; "
        f"dsph/dtri/dcam max|diff| {' / '.join(f'{e:.3e}' for e in errs)}")
    return max(errs)


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
        sph, tri, tri_cl = _grad_tables(scene, parity)
        if "clusters" in name and tri_cl is None:
            raise SystemExit(f"{name}: expected cluster tables")
        band = band or {}
        rows = band.get("shard_rows", GRAD_SMALL["height"])
        g = torch.randn(rows, GRAD_SMALL["width"], 3, device=dev,
                        generator=gen)
        cv = tables.camera_vec(cam)
        kw = dict(GRAD_SMALL, parity_plane_sign=parity, tri_clusters=tri_cl,
                  **band)
        kern = wb.grad_slab_cuda(sph, tri, g, cv, **kw)
        torch.cuda.synchronize()
        worst = max(worst, _hold_k5(name, kern, wb.grad_slab_ref(
            sph, tri, g, cv, **kw), sph.shape[1], tri.shape[1]))

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
    # make_loss_fn's interior gradients (no silhouette terms: those are
    # phase 4g's make_silhouette_train_step) do not descend on this
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


SIL_SMALL = dict(width=64, height=36, samples_per_pixel=2, depth=4)
SIL_ESTIMATORS = ("silhouette_grad", "mirror_silhouette_grad",
                  "glass_silhouette_grad", "triangle_silhouette_grad",
                  "mirror_triangle_silhouette_grad")
SIL_BAR = 1e-3
MIRROR_SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material MIRROR : Metal color 0.9 0.8 0.7 fuzz 0.0;
sphere center 0.0 0.0 -2.0 radius 0.9 material MIRROR;
"""


def _kernel_launches() -> int:
    """The sum of every kernel's launch counter (K1, K1-lowp, K2, K3, K4,
    K5, K5s, K6)."""
    from raytracer_tpu_torch.ops.cuda import (wavefront, wavefront_binned,
                                              wavefront_bwd,
                                              wavefront_sorted,
                                              wavefront_stream)
    return (wavefront.LAUNCHES + wavefront.STREAM_LAUNCHES
            + wavefront.LOWP_LAUNCHES + wavefront_bwd.LAUNCHES
            + wavefront_bwd.STREAM_LAUNCHES + wavefront_binned.LAUNCHES
            + wavefront_sorted.LAUNCHES + wavefront_stream.LAUNCHES)


def _zero_kernel_launches() -> None:
    from raytracer_tpu_torch.ops.cuda import (wavefront, wavefront_binned,
                                              wavefront_bwd,
                                              wavefront_sorted,
                                              wavefront_stream)
    wavefront.LAUNCHES = wavefront.STREAM_LAUNCHES = 0
    wavefront.LOWP_LAUNCHES = 0
    wavefront_bwd.LAUNCHES = wavefront_bwd.STREAM_LAUNCHES = 0
    wavefront_binned.LAUNCHES = wavefront_sorted.LAUNCHES = 0
    wavefront_stream.LAUNCHES = 0


class _SilhouetteProbe:
    """Wraps the silhouette module's interior term, its five estimators
    and its top-k selection while active: records each call's outputs
    (``record``) or its milliseconds on the card (host clock, a sync before
    and after; ``timed``)."""

    PARTS = ("_interior",) + SIL_ESTIMATORS

    def __init__(self, timed: bool):
        from raytracer_tpu_torch.grad import silhouette as sil
        self.sil, self.timed = sil, timed
        self.outputs, self.ms, self.picks = {}, {}, []

    def __enter__(self):
        self.saved = {n: getattr(self.sil, n) for n in self.PARTS + ("_top",)}
        for name in self.PARTS:
            setattr(self.sil, name, self._wrap(name, self.saved[name]))
        top = self.saved["_top"]

        def record_top(score, n):
            out = top(score, n)
            self.picks.append(out.cpu())
            return out

        self.sil._top = record_top
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.sil, name, fn)

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            if self.timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.timed:
                torch.cuda.synchronize()
                self.ms.setdefault(name, []).append(
                    (time.perf_counter() - t0) * 1e3)
            elif name != "_interior":
                self.outputs[name] = [x.detach().cpu() for x in out]
            return out
        return call


def _sil_agreement(rtt, world: str, fields) -> float:
    """value_and_grad_with_silhouette on the card and on the CPU at
    SIL_SMALL: every grad leaf and every estimator's output within
    SIL_BAR * max|cpu| + 1e-6, the loss within 1e-5 relative, the same
    edges selected.  Returns the worst gap over max|cpu|."""
    from raytracer_tpu_torch import grad
    w = getattr(rtt.models, world)()
    scene, cam = w.to_scene(), w.to_camera()
    target, _ = rtt.render_linear(scene, cam, seed=0, **SIL_SMALL)
    # the training path's start: centres (and vertices) + 0.02, radii as
    # they are (a radius x 1.03 puts the camera inside the ground sphere,
    # whose silhouette then has NaN velocities, in the JAX package too)
    params = grad.extract_params(scene, fields)
    for k in params:
        if k != "sphere_radius":
            params[k] = params[k] + 0.02
    runs = {}
    for dev in ("cuda", "cpu"):
        with _SilhouetteProbe(timed=False) as probe:
            loss, grads = grad.value_and_grad_with_silhouette(
                scene, cam, target, params, seed=1, device=dev, **SIL_SMALL)
        if not grads[fields[0]].device.type == dev:
            raise SystemExit(f"silhouette: grads on {grads[fields[0]].device}"
                             f", asked for {dev}")
        runs[dev] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                     probe.outputs, probe.picks)
    (lc, gc, ec, pc), (lh, gh, eh, ph) = runs["cuda"], runs["cpu"]
    worst = 0.0
    pairs = [(f"grad {k}", gc[k], gh[k]) for k in gh]
    if set(ec) != set(eh):
        raise SystemExit(f"silhouette {world}: estimators {sorted(ec)} on "
                         f"the card, {sorted(eh)} on the CPU")
    pairs += [(f"{n}[{i}]", a, b) for n in eh
              for i, (a, b) in enumerate(zip(ec[n], eh[n]))]
    for name, a, b in pairs:
        if not torch.isfinite(a).all():
            raise SystemExit(f"silhouette {world}: {name} not finite on the "
                             f"card")
        scale = float(b.abs().max()) if b.numel() else 0.0
        gap = float((a - b).abs().max()) if b.numel() else 0.0
        worst = max(worst, gap / max(scale, 1e-30))
        if not gap <= SIL_BAR * scale + 1e-6:
            raise SystemExit(f"silhouette {world}: {name} card vs CPU gap "
                             f"{gap:.3e} over max|cpu| {scale:.3e}")
    same_picks = len(pc) == len(ph) and all(
        torch.equal(a, b) for a, b in zip(pc, ph))
    log(f"  {world} {SIL_SMALL} {fields}: loss card {lc:.9e} CPU {lh:.9e}; "
        f"estimators {sorted(eh)}; worst gap / max|cpu| {worst:.3e}; "
        f"{len(ph)} edge selections identical: {same_picks}")
    if not abs(lc - lh) <= 1e-5 * abs(lh) or not same_picks:
        raise SystemExit(f"silhouette {world}: loss {lc} vs {lh}, selections "
                         f"identical {same_picks}")
    return worst


def _sil_train(rtt) -> dict:
    """5 silhouette train steps at GRAD_FULL: ms a step and its split,
    peak memory, kernel launches (0: the path runs outside the kernels)."""
    from raytracer_tpu_torch import grad
    dev = torch.device("cuda")
    w = rtt.models.default_world()
    scene, cam = w.to_scene(dev), w.to_camera(dev)
    with torch.no_grad():
        target, _ = rtt.render_linear(scene, cam, seed=0, **GRAD_FULL)
    params = grad.extract_params(scene, ["sphere_center", "sphere_radius"])
    params["sphere_center"] = params["sphere_center"] + 0.02
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    step = grad.make_silhouette_train_step(
        scene, cam, target, torch.optim.Adam(params.values(), lr=1e-2),
        seed=1, device="cuda", **GRAD_FULL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_kernel_launches()
    losses, step_ms = [], []
    with _SilhouetteProbe(timed=True) as probe:
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(params)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = {n: probe.ms.get(n, []) for n in probe.PARTS}
    log(f"  training path, default world {GRAD_FULL}, sphere_center + 0.02 "
        f"and sphere_radius, Adam lr 1e-2: losses {losses}")
    log(f"    step ms {[round(t, 3) for t in step_ms]}; peak device memory "
        f"{peak:.3f} GiB; kernel launches over the 5 steps {launches}")
    for n, ts in split.items():
        log(f"    {n}: ms {[round(t, 3) for t in ts]}")
    if launches != 0 or not all(np.isfinite(losses)):
        raise SystemExit(f"silhouette training path: kernel launches "
                         f"{launches}, losses {losses}")
    if any(len(ts) != 5 for n, ts in split.items()
           if n not in ("triangle_silhouette_grad",
                        "mirror_triangle_silhouette_grad")):
        raise SystemExit(f"silhouette training path: estimator calls "
                         f"{ {n: len(ts) for n, ts in split.items()} }")
    return dict(losses=losses, step_ms=step_ms, peak_gib=peak,
                split={n: statistics.median(ts) for n, ts in split.items()
                       if ts}, launches=launches)


def _sil_obj_fit(rtt) -> dict:
    """scripts/obj_silhouette_fit.py on the card: a rigid offset of the
    OBJ-10k mesh recovered through value_and_grad_with_silhouette, with the
    script's bars."""
    from raytracer_tpu_torch import grad
    dev = torch.device("cuda")
    scene, cam = rtt.models.obj_mesh_scene(device=dev)
    if scene.num_triangles != 10240:
        raise SystemExit(f"OBJ fit: {scene.num_triangles} triangles")
    kw = dict(width=64, height=64, samples_per_pixel=2, depth=2,
              parity_plane_sign=False, seed=3)
    with torch.no_grad():
        target, _ = rtt.render_linear(scene, cam, **kw)
    base = grad.extract_params(scene, ["tri_v0", "tri_v1", "tri_v2"])
    off = torch.tensor([0.06, -0.04, 0.0], device=dev)
    t_est = off.clone().requires_grad_(True)
    opt = torch.optim.Adam([t_est], lr=1.5e-2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    with _SilhouetteProbe(timed=True) as probe:
        for i in range(30):
            cur = {k: v + t_est.detach() for k, v in base.items()}
            loss, grads = grad.value_and_grad_with_silhouette(
                scene, cam, target, cur, samples_per_edge=4,
                max_edges=1024, device=dev, **kw)
            # dL/dt of v_k = v_k0 + t: the per-vertex gradients summed
            t_est.grad = sum(g.sum(0) for g in grads.values())
            opt.step()
            losses.append(float(loss))
            if i % 5 == 0:
                log(f"    step {i}: loss {losses[-1]:.6e} t "
                    f"{t_est.detach().cpu().numpy()}")
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / 30
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    err0 = float(off.abs().mean())
    err1 = float(t_est.detach().abs().mean())
    split = {n: statistics.median(ts) for n, ts in probe.ms.items()}
    log(f"  OBJ-10k silhouette fit (64x64, 2 spp, depth 2, correct sign, "
        f"samples_per_edge 4, max_edges 1024, 30 Adam steps at 1.5e-2): "
        f"loss {losses[0]:.6e} -> {losses[-1]:.6e}, mean |offset error| "
        f"{err0:.6f} -> {err1:.6f}; {sec * 1e3:.3f} ms a step (medians: "
        + ", ".join(f"{n} {ms:.3f} ms" for n, ms in split.items())
        + f"), peak device memory {peak:.3f} GiB")
    if not (losses[-1] < 0.6 * losses[0] and err1 < 0.6 * err0):
        raise SystemExit("OBJ silhouette fit: the script's bars not met")
    return dict(loss=(losses[0], losses[-1]), err=(err0, err1),
                s_step=sec, split=split, peak_gib=peak)


def _sil_fit(rtt) -> dict:
    """fit(silhouette=True, device="cuda") as
    test_silhouette_fit_recovers_large_offset sets it up, with its bars."""
    from raytracer_tpu_torch import grad
    w = rtt.parse_input(MIRROR_SRC)
    scene, cam = w.to_scene(), w.to_camera()
    kw = dict(width=24, height=24, samples_per_pixel=2, depth=2, seed=4)
    target, _ = rtt.render_linear(scene, cam, **kw)
    p0 = grad.extract_params(scene, ["sphere_center"])
    true_c = p0["sphere_center"].clone()
    p0["sphere_center"] = p0["sphere_center"] + torch.tensor(
        [[0.22, -0.18, 0.0]])
    err0 = float((p0["sphere_center"] - true_c).abs().max())
    t0 = time.perf_counter()
    res = grad.fit(scene, cam, target, p0, steps=40, learning_rate=2e-2,
                   silhouette=True, device="cuda", **kw)
    sec = time.perf_counter() - t0
    c = res.params["sphere_center"]
    if c.device.type != "cuda":
        raise SystemExit(f"silhouette fit: params on {c.device}")
    err1 = float((c.cpu() - true_c).abs().max())
    log(f"  fit(silhouette=True) MIRROR_SRC 24x24, 2 spp, depth 2, 40 steps "
        f"at lr 2e-2: loss {res.losses[0]:.6e} -> {res.losses[-1]:.6e}, max "
        f"|centre error| {err0:.4f} -> {err1:.4f} ({sec:.2f} s)")
    if not (res.losses[-1] < 0.6 * res.losses[0] and err1 < 0.5 * err0):
        raise SystemExit("silhouette fit: the JAX test's bars not met")
    return dict(loss=(res.losses[0], res.losses[-1]), err=(err0, err1),
                seconds=sec)


def phase_silhouette(rtt, smi: str) -> dict:
    """4g: the silhouette path (grad/silhouette.py) on the card."""
    t0 = time.perf_counter()
    log(f"\nthe silhouette path on {smi}: card against CPU")
    worst = max(_sil_agreement(rtt, "default_world",
                               ["sphere_center", "sphere_radius"]),
                _sil_agreement(rtt, "ffi_example_world",
                               ["sphere_center", "sphere_radius", "tri_v0",
                                "tri_v1", "tri_v2"]))
    out = dict(worst=worst, train=_sil_train(rtt), obj=_sil_obj_fit(rtt),
               fit=_sil_fit(rtt))
    log(f"  silhouette phase: {time.perf_counter() - t0:.1f} s")
    return out


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
    sph, tri, _ = _grad_tables(s, True)
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
    plain_ms, plain = _sync_ms(lambda: wb.grad_slab_ref(sph, tri, g, cv,
                                                        **kw))
    log(f"  K5 plain version {plain_ms:.3f} ms")
    err = _hold_k5(f"K5 vs plain at {GRAD_FULL}", (kslab, kcam), plain,
                   sph.shape[1], tri.shape[1])
    b = bound(kseg * (2 * (sph.shape[1] * FLOPS_SPHERE + FLOPS_SHADE)
                      + FLOPS_ADJOINT), nbytes(sph, tri, g, cv, kslab, kcam))
    log(f"  K5 bound {b[0]:.4f} ms by {b[1]}")
    return dict(paths_per_s=paths / sec, ms=ms, plain_ms=plain_ms,
                k1_ms=k1_ms, k1_err=k1_err, k5_err=err, bound=b)


# ---------------------------------------------------------------------------
# the mesh engines: K3 (binned) and K4 (streamed)
# ---------------------------------------------------------------------------

MESH_SMALL = dict(width=64, height=36, depth=4, seed=3)
MESH_FULL = dict(width=512, height=512, samples_per_pixel=4, depth=4)
API_SHAPE = dict(width=512, height=288, samples_per_pixel=4, depth=4)
# float32 operations (add, multiply, divide, square root), counted from
# csrc/path_common.cuh: a sphere test, the shading a traced segment needs
# (sphere and triangle normal fix-ups, the draw, the three scatters, the
# bookkeeping), a slab test (aabb_test; K3's next-top selection does one
# per top or supertop), a bounding-sphere test (bound_test) and a triangle
# test (tri_step); the mesh kernels' node and triangle tests are counted
# from each run's rays by _walk_ops
FLOPS_SPHERE, FLOPS_SHADE, FLOPS_BOX = 19, 120, 12
FLOPS_BOUND, FLOPS_TRI = 19, 51
WARP = 32
# the adjoint sweep of K5 per segment (an estimate from wavefront_bwd.cu)
FLOPS_ADJOINT = 250
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12     # H100 SXM float32, HBM3


def bound(ops, nbytes):
    """(bound ms, what bounds it) for ``ops`` float32 operations and
    ``nbytes`` bytes on the H100's published peaks."""
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts):
    out = 0
    for t in ts:
        if isinstance(t, torch.Tensor):
            out += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            out += nbytes(*t)
    return out


def big_mesh_scene(rtt):
    """bench.py:132-146: two subdivision-6 icospheres, 163,840 triangles."""
    from raytracer_tpu_torch.models.builders import icosphere_mesh
    from raytracer_tpu_torch.scene import (DIFFUSE, METAL, build_materials,
                                           build_scene)
    tris = (icosphere_mesh((-0.6, 0.0, -1.4), 0.45, 0, 6)
            + icosphere_mesh((0.6, 0.0, -1.2), 0.45, 2, 6))
    mats = build_materials([(DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                            (DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0),
                            (METAL, (0.85, 0.85, 0.9), 0.05, 1.0)])
    scene = build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                        exact_planes=True)
    return scene, rtt.Camera.new_at((0.0, 0.0, 0.0), 1.77778)


def mesh_scenes(rtt):
    return {"mesh-1292": rtt.models.mesh_scene(3),
            "OBJ-10k": rtt.models.obj_mesh_scene(),
            "164k": big_mesh_scene(rtt)}


def compare_image(name, kernel, plain):
    """Hold a kernel's mean image against its plain version's: equal
    segments, and max|diff| <= TOL except on at most 0.01% of the pixels
    (exact triangle ties), each reported."""
    (km, ks), (pm, ps) = kernel, plain
    if not torch.isfinite(km).all():
        raise SystemExit(f"{name}: kernel output is not finite")
    d = (km - pm).abs().amax(dim=-1)
    err = float(d.max())
    bad = (d > TOL).nonzero().tolist()
    log(f"  {name}: max|diff| {err:.3e}, segments kernel {ks} plain {ps}, "
        f"{len(bad)} pixels over {TOL}" + (f": {bad[:8]}" if bad else ""))
    if len(bad) > 1e-4 * d.numel() or ks != ps:
        raise SystemExit(f"{name}: kernel disagrees with the plain version "
                         f"(max|diff| {err}, {len(bad)} pixels, segments "
                         f"{ks} vs {ps})")
    return err


def compare_bitwise(name, kernel, plain):
    """Hold a kernel's mean image bitwise against its plain version's:
    max|diff| 0 and equal segments; pixels that differ (an exact triangle
    tie would show here) are reported."""
    (km, ks), (pm, ps) = kernel, plain
    if not torch.isfinite(km).all():
        raise SystemExit(f"{name}: kernel output is not finite")
    d = (km - pm).abs().amax(dim=-1)
    err = float(d.max())
    bad = (d > 0).nonzero().tolist()
    log(f"  {name}: max|diff| {err:.3e}, segments kernel {ks} plain {ps}, "
        f"{len(bad)} pixels differ" + (f": {bad[:8]}" if bad else ""))
    if bad or ks != ps:
        raise SystemExit(f"{name}: kernel is not bitwise its plain version "
                         f"(max|diff| {err}, {len(bad)} pixels, segments "
                         f"{ks} vs {ps})")
    return err


def _sphere_test(b):
    """bound_test of every ray against every column of b (4, M): [n, M]."""
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    return lambda ray, cull: ws.bound_test(
        b, slice(None), [x[:, None] for x in ray], cull[:, None])


def _box_test(a):
    """aabb_test of every ray against every column of a (6, M): [n, M]."""
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb

    def test(ray, cull):
        tn, tf = wb._aabb_entry(a, ray, [wfc._inv_dir(d) for d in ray[3:]])
        return (tn <= tf) & (tf > wfc.T_MIN) & (tn <= cull[:, None])
    return test


def _parents(ranges, n_children):
    """[n_children] index of the node whose (2, C) child range holds each
    child."""
    parent = torch.zeros(n_children, dtype=torch.long, device=ranges.device)
    for k, (c0, c1) in enumerate(ranges.t().tolist()):
        parent[c0:c1] = k
    return parent


def _walk_ops(ray, alive, cull, wid, n_warps, levels, leaf_tris):
    """Float32 operations of one bounce's culled walk, as (the rays' own,
    the warps').  ``levels``: (test(ray, cull) -> [n, M] bool, each node's
    parent in the level above or None, operations per test), top level
    first; ``leaf_tris``: triangles in each node of the last level; ``wid``:
    each lane's warp.  The rays' own count, the bound's, charges each live
    ray for the nodes whose parent it passes itself (a top-level node: that
    it passes) and the triangles of the leaves it passes.  The warps' count
    is what the SIMT kernel executes: a warp tests a node when a live lane
    of it passes the node's parent (a top-level node: when one passes the
    node itself) and a leaf's triangles when one passes the leaf, all 32
    lanes each test; its excess over the rays' own is divergence.  The
    culling distance is each ray's final closest hit (capped as the kernel
    caps it), never above the walk's own at any step, so the walk makes
    every test counted here; top-level tests that fail are left out."""
    n = ray[0].shape[0]
    f64 = torch.float64
    lane, acc = torch.zeros((), dtype=f64, device=alive.device), \
        [None] * len(levels)
    for i in range(0, n, 1 << 15):
        sl = slice(i, i + (1 << 15))
        above = None
        for k, (test, parent, flops) in enumerate(levels):
            m = test([x[sl] for x in ray], cull[sl]) & alive[sl, None]
            if acc[k] is None:
                acc[k] = torch.zeros((n_warps, m.shape[1]),
                                     dtype=torch.int32, device=m.device)
            acc[k].index_add_(0, wid[sl], m.to(torch.int32))
            tested = m if parent is None else above[:, parent]
            lane += flops * tested.sum(dtype=f64)
            above = m & tested
        lane += FLOPS_TRI * (above.to(f64) @ leaf_tris.to(f64)).sum()
    warp, above = 0.0, None
    for (_, parent, flops), a in zip(levels, acc):
        p = a > 0
        tested = p if parent is None else above[:, parent]
        warp += flops * float(tested.sum())
        above = p & tested
    warp += FLOPS_TRI * float((above.double() @ leaf_tris.double()).sum())
    return float(lane), WARP * warp


def _pixel_walk_ops(records, levels, leaf_tris, width):
    """_walk_ops summed over the recorded bounces of a fused kernel's plain
    version (sphere_hits calls: ray, live lanes and, after the walk, the
    final hit of each pixel lane, row-major over the band), with K1's
    8x4-pixel warps."""
    lane = warp = 0.0
    for a, _, h in records:
        ray, alive = a[2], a[3]
        idx = torch.arange(alive.shape[0], device=alive.device)
        row, col = idx // width, idx % width
        wid = (row // 4) * -(-width // 8) + col // 8
        r, w = _walk_ops(ray, alive, h[0], wid, int(wid.max()) + 1, levels,
                         leaf_tris)
        lane, warp = lane + r, warp + w
    return lane, warp


def _layout_walk_ops(records, levels, leaf_tris, width, rows, spp):
    """_walk_ops summed over the recorded bounces of a (pixel, sample)
    kernel's plain version (scatter_bookkeep calls: ray, closest hit,
    sample, bounce, live lanes, row-major over the band), with the kernel's
    warps (thread_layout: K4, K2, K5s): one warp's lanes at a bounce are
    its pixels' samples of one run, so records of one run and bounce trace
    together."""
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    lay = ws.thread_layout(width, rows, spp)
    dev = leaf_tris.device
    idx = torch.arange(rows * width, device=dev)
    row, col = idx // width, idx % width
    pwarp = (row // lay.tile_h) * lay.tiles_x + col // lay.tile_w
    groups = {}
    for a, _, _ in records:
        ray, h, s, b, alive = a[0], a[1], a[3], a[4], a[7]
        groups.setdefault((s // lay.run, b), []).append(
            (ray, alive, h[0], pwarp * lay.chunks + s // lay.run))
    lane = warp = 0.0
    for recs in groups.values():
        r, w = _walk_ops([torch.cat([x[0][k] for x in recs])
                          for k in range(6)],
                         torch.cat([x[1] for x in recs]),
                         torch.cat([x[2] for x in recs]),
                         torch.cat([x[3] for x in recs]),
                         lay.n_tiles * lay.chunks, levels, leaf_tris)
        lane, warp = lane + r, warp + w
    return lane, warp


def _k4_walk_ops(records, sargs, subb, width, rows, spp):
    """K4's walk over one band: top, leaf and sub-leaf bounding spheres,
    then a sub-leaf's triangles (_layout_walk_ops)."""
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    _, _, leafb, leafn, topb, topr, _, _ = sargs
    dev = leafb.device
    n_leaves = leafb.shape[1]
    counts = leafn[0].repeat_interleave(ws.SUBS) - torch.arange(
        ws.SUBS, device=dev).repeat(n_leaves) * ws.SUB
    levels = [(_sphere_test(topb), None, FLOPS_BOUND),
              (_sphere_test(leafb), _parents(topr, n_leaves), FLOPS_BOUND),
              (_sphere_test(subb), torch.arange(
                  n_leaves * ws.SUBS, device=dev) // ws.SUBS, FLOPS_BOUND)]
    return _layout_walk_ops(records, levels, counts.clamp(0, ws.SUB), width,
                            rows, spp)


def _k3_walk_ops(passes, hits):
    """_walk_ops summed over the recorded passes of K3's plain version
    (binned_pass_ref calls and their sphere_hits calls), with warps of 32
    consecutive slots and the culling cap of binned_pass_ref: the root exit
    and, after the primary pass, the walk-exit bound."""
    from raytracer_tpu_torch.ops import tables as tb
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    lane = warp = 0.0
    for (pa, _, _), (ha, _, h) in zip(passes, hits):
        T, state, ray, alive = pa[0], pa[2], ha[2], ha[3]
        levels = [(_box_test(T.topa), None, FLOPS_BOX),
                  (_box_test(T.grpa), _parents(T.topr, T.grpa.shape[1]),
                   FLOPS_BOX),
                  (_box_test(T.suba), torch.arange(
                      T.suba.shape[1], device=alive.device) // tb.GROUP_SUBS,
                   FLOPS_BOX)]
        rcx, rcy, rcz, rr2 = T.root[:, 0].tolist()
        ox, oy, oz, dx, dy, dz = ray
        ocx, ocy, ocz = ox - rcx, oy - rcy, oz - rcz
        rhb = ocx * dx + ocy * dy + ocz * dz
        rdisc = rhb * rhb - (ocx * ocx + ocy * ocy + ocz * ocz - rr2)
        rexit = -rhb + torch.sqrt(torch.clamp_min(rdisc, 0.0))
        root_p = (rdisc >= 0.0) & (rexit > wfc.T_MIN) & alive & (rr2 > 0.0)
        cap = torch.where(root_p, rexit * wb._EXIT_MUL + wb._EXIT_ADD,
                          -wfc.BIG)
        if state is not None:
            cap = torch.minimum(cap, state[wb.ST_EXITB])
        n = alive.shape[0]
        wid = torch.arange(n, device=alive.device) // WARP
        r, w = _walk_ops(ray, alive, torch.minimum(h[0], cap), wid,
                         n // WARP, levels, T.subn[0])
        lane, warp = lane + r, warp + w
    return lane, warp


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _binned_args(ops, tables, scene, cam, dev):
    (sph, scl, *t) = ops.scene_sorted_tables(scene, dev)
    order, keys = ops._camera_order(t[4], cam, dev)
    return (sph, *t, tables.camera_vec(cam).to(dev)), dict(
        sph_clusters=scl, top_order=order, top_keys=keys)


def phase_mesh_vs_plain(rtt, scenes) -> dict:
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    dev = torch.device("cuda")
    log(f"\nK4 and K3 vs plain versions at {MESH_SMALL}")
    worst = {"K3": 0.0, "K4": 0.0}
    out = {"plain_ms": {}, "table_ms": {}}
    for label, (scene, cam) in scenes.items():
        ms_sorted, _ = _sync_ms(lambda: ops.scene_sorted_tables(scene, dev))
        ms_stream, _ = _sync_ms(lambda: ops.scene_stream_tables(scene, dev))
        out["table_ms"][label] = (ms_sorted, ms_stream)
        log(f"  {label}: {scene.num_triangles} triangles; host table builds "
            f"sorted {ms_sorted:.3f} ms, streamed {ms_stream:.3f} ms")
        shape = dict(MESH_SMALL, samples_per_pixel=2 if label == "164k"
                     else 4)
        _, args, kw = ops._stream_call(scene, cam, dev, plain=False)
        k = ws.render_linear_stream_cuda(*args, **shape, **kw)
        pms4, p = _sync_ms(lambda: ws.render_linear_stream_ref(
            *args, **shape, **kw))
        worst["K4"] = max(worst["K4"], compare_bitwise(f"K4 {label}", k, p))
        bargs, bkw = _binned_args(ops, tables, scene, cam, dev)
        k = wb.render_linear_binned(*bargs, **shape, **bkw)
        pms3, p = _sync_ms(lambda: wb.render_linear_binned(
            *bargs, **shape, **bkw, plain=True))
        worst["K3"] = max(worst["K3"], compare_image(f"K3 {label}", k, p))
        out["plain_ms"][label] = (pms3, pms4)
        log(f"  {label}: plain versions K3 {pms3:.3f} ms, K4 {pms4:.3f} ms "
            f"at spp {shape['samples_per_pixel']}")
        variants = {"node_exit off": dict(node_exit=False),
                    "generous caps": dict(bounce_caps=(1 << 22,) * 3)}
        variants["super_selection " + ("off" if label == "164k" else "on")] \
            = dict(super_selection=label != "164k")
        for vname, extra in variants.items():
            got = wb.render_linear_binned(*bargs, **shape, **bkw, **extra)
            if not torch.equal(got[0], k[0]) or got[1] != k[1]:
                raise SystemExit(f"K3 {label} with {vname} is not bitwise "
                                 f"the default run")
        _, _, over = wb.render_linear_binned(*bargs, **shape, **bkw,
                                             bounce_caps=(32,) * 3)
        if not over > 0:
            raise SystemExit(f"K3 {label}: tiny caps did not trip the guard")
        log(f"  {label}: K3 with {', '.join(variants)} bitwise equal to the "
            f"default; caps of 32 slots overflow by {over} rays")
    # a K4 band against the rows of a whole K4 render
    scene, cam = scenes["OBJ-10k"]
    _, args, kw = ops._stream_call(scene, cam, dev, plain=False)
    shape = dict(MESH_SMALL, samples_per_pixel=4)
    whole, _ = ws.render_linear_stream_cuda(*args, **shape, **kw)
    band = ws.render_linear_stream_cuda(*args, **shape, **kw, shard_rows=8,
                                        row_offset=9)
    worst["K4"] = max(worst["K4"], compare_bitwise(
        "K4 OBJ-10k band rows 9..16", band, ws.render_linear_stream_ref(
            *args, **shape, **kw, shard_rows=8, row_offset=9)))
    if not torch.equal(band[0], whole[9:17]):
        raise SystemExit("K4 band differs from the whole render's rows")
    log("  K4 band rows are bitwise the whole render's")
    out["worst"] = worst
    return out


def _counters():
    """kernel -> (wrapper module, its counter)."""
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wbw
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    return {"K1": (wfc, "LAUNCHES"), "K2": (wfc, "STREAM_LAUNCHES"),
            "K5": (wbw, "LAUNCHES"), "K5s": (wbw, "STREAM_LAUNCHES"),
            "K3": (wb, "LAUNCHES"), "K4": (ws, "LAUNCHES"),
            "K6": (wso, "LAUNCHES"), "K1-lowp": (wfc, "LOWP_LAUNCHES")}


def _zero_counts():
    for m, name in _counters().values():
        setattr(m, name, 0)


def _read_counts():
    return {k: getattr(m, name) for k, (m, name) in _counters().items()}


def _only(**launches):
    """The launch counts of a run that launched only ``launches``."""
    return {k: launches.get(k, 0) for k in _counters()}


def _lsb_check(name, fb, ref):
    diff = np.abs(fb.astype(np.int32) - ref.astype(np.int32)).max(-1)
    over = int((diff > 1).sum())
    log(f"  {name} vs K1's framebuffer: max {int(diff.max())} LSB, "
        f"{int((diff > 0).sum())} pixels differ, {over} by more than 1 LSB "
        f"of {diff.size}")
    if over > 1e-4 * diff.size:
        raise SystemExit(f"{name}: {over} pixels differ from K1's by more "
                         f"than 1 LSB")


def _caps(ops, scene, width, height):
    """The autotuned caps of ``scene``'s frames at this shape."""
    return next(v[1] for k, v in ops._BINNED_CAPS.items()
                if k[0] == id(scene) and k[2:4] == (width, height))


def _session_capped_frame(scene, cam, fb, seed) -> float:
    """The session's camera again through ``render_linear_fast`` (the
    session's own path, now capped): K3 launches only, no new probe, the
    probe frame's framebuffer, bitwise the uncapped kernel frame, and
    within the bar of the plain version under the same caps."""
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    from raytracer_tpu_torch.render import finalize_image
    dev = torch.device("cuda")
    probes = len(ops._BINNED_CAPS)
    _zero_counts()
    capped = ops.render_linear_fast(scene, cam, device=dev, seed=seed,
                                    **API_SHAPE)
    counts = _read_counts()
    caps = _caps(ops, scene, 512, 288)
    args, kw = _binned_args(ops, tables, scene, cam, dev)
    whole = wb.render_linear_binned(*args, **API_SHAPE, seed=seed, **kw)
    plain = wb.render_linear_binned(*args, **API_SHAPE, seed=seed, **kw,
                                    bounce_caps=caps, plain=True)
    log(f"  capped frame (caps {caps}): launches {counts}, new probe "
        f"{len(ops._BINNED_CAPS) != probes}")
    if counts != _only(K3=4) or len(ops._BINNED_CAPS) != probes:
        raise SystemExit(f"API capped frame: launches {counts}")
    if not torch.equal(capped[0], whole[0]) or capped[1] != whole[1]:
        raise SystemExit("API capped frame differs from the uncapped K3 "
                         "frame")
    if not np.array_equal(finalize_image(capped[0]).cpu().numpy(), fb):
        raise SystemExit("API capped frame differs from the session's "
                         "probe framebuffer")
    if plain[2] != 0:
        raise SystemExit(f"plain version under the caps dropped {plain[2]} "
                         f"live rays")
    log("  capped frame bitwise the uncapped K3 frame and the session's "
        "framebuffer")
    return compare_image("K3 capped frame vs plain version, same caps",
                         capped, plain[:2])


def phase_mesh_main_paths(rtt, scenes) -> dict:
    from raytracer_tpu_torch import api, cli, image, ops
    from raytracer_tpu_torch.models import obj as obj_mod
    from raytracer_tpu_torch.render import finalize_image
    dev = torch.device("cuda")
    scene, cam = scenes["OBJ-10k"]
    opts = rtt.Options(samples_per_pixel=4, max_ray_bounces=4)
    session = api.RenderSession.from_world(scene, cam, 512, 288, opts,
                                           device="cuda")
    engine = session.resolved_engine()
    log(f"\nmain path: RenderSession.from_world(OBJ-10k, 512, 288, spp 4, "
        f"depth 4) resolves to {engine}")
    if engine != "cuda_binned":
        raise SystemExit(f"API session resolved to {engine}")
    k3 = 0
    for step in ("first frame", "frame after a camera move"):
        probes = len(ops._BINNED_CAPS)
        _zero_counts()
        ms, fb = _sync_ms(session.frame)
        counts = _read_counts()
        k3 += counts["K3"]
        new_probe = len(ops._BINNED_CAPS) == probes + 1
        log(f"  {step}: {ms:.3f} ms, launches {counts}, a new probe "
            f"{new_probe}")
        if counts != _only(K3=4) or not new_probe:
            raise SystemExit(f"API session {step}: launches {counts}, new "
                             f"probe {new_probe}")
        if step == "first frame":
            mean, _ = ops.render_linear_fast(
                scene, cam, device=dev, seed=opts.seed, engine="cuda",
                **dict(API_SHAPE, samples_per_pixel=4))
            _lsb_check("API frame", fb, finalize_image(mean).cpu().numpy())
            k3_err = _session_capped_frame(scene, cam, fb, opts.seed)
            session.move_camera(0.05, 0.0, 0.0)

    # the CLI's obj= on the OBJ-10k triangles, written out as an OBJ file
    h = scene.numpy()
    tris = [(tuple(h.tri_v0[i]), tuple(h.tri_v1[i]), tuple(h.tri_v2[i]),
             int(h.tri_mat[i])) for i in np.nonzero(h.tri_valid)[0]]
    args = ["width=512", "samples=16", "ray_depth=8"]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "obj10k.obj"
        path.write_text(obj_mod.dump_obj(tris))
        out = str(Path(tmp) / "image.ppm")
        _zero_counts()
        t0 = time.perf_counter()
        rc = cli.main(args + [f"obj={path}", f"out={out}"])
        dt = time.perf_counter() - t0
        counts = _read_counts()
        fb = image.read_ppm(out)
        cli_scene = cli._obj_scene(str(path))
    log(f"  cli.main({args + ['obj=<OBJ-10k>']}) rc={rc} in {dt:.3f}s, "
        f"launches {counts}, framebuffer {fb.shape}")
    if rc != 0 or counts != _only(K4=16):
        raise SystemExit(f"CLI obj=: rc {rc}, launches {counts} (expected "
                         f"16 K4 bands)")
    import math
    cli_cam = rtt.Camera.new_look_at((0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                                     (0.0, 1.0, 0.0), math.pi / 2.0, 1.77778)
    mean, _ = ops.render_linear_fast(
        cli_scene, cli_cam, width=512, height=fb.shape[0],
        samples_per_pixel=16, depth=8, device=dev, seed=rtt.rng.DEFAULT_SEED,
        engine="cuda")
    _lsb_check("CLI obj= frame", fb, finalize_image(mean).cpu().numpy())
    # the CLI's frame again through K4 and through its plain version, at
    # the CLI's own shape and bands
    cli_kw = dict(width=512, height=fb.shape[0], samples_per_pixel=16,
                  depth=8, device=dev, seed=rtt.rng.DEFAULT_SEED,
                  progress=lambda *a: None)
    k4 = ops.render_linear_fast(cli_scene, cli_cam, engine="cuda_stream",
                                **cli_kw)
    if not np.array_equal(finalize_image(k4[0]).cpu().numpy(), fb):
        raise SystemExit("CLI obj=: the K4 frame is not the CLI's "
                         "framebuffer")
    plain_ms, walk = _k4_plain_counted(lambda: ops.render_linear_fast(
        cli_scene, cli_cam, engine="torch_stream", **cli_kw), cli_kw)
    p4 = walk.pop("result")
    k4_err = compare_bitwise(f"K4 vs plain at the CLI's shape (512x"
                             f"{fb.shape[0]}, 16 spp, depth 8, 16 bands)",
                             k4, p4)
    log(f"  K4's frame is the CLI's framebuffer; plain version "
        f"{plain_ms:.3f} ms")
    return dict(k3_launches=k3, k4_launches=counts["K4"], k3_err=k3_err,
                k4_err=k4_err, cli=dict(scene=cli_scene, cam=cli_cam,
                                        segs=k4[1], plain_ms=plain_ms,
                                        **walk))


def _k4_plain_counted(render, shape):
    """(ms, counts) of a render whose K4 plain-version calls (bands) are
    each timed alone (host clock between syncs) and their walk counted by
    _k4_walk_ops as soon as they return, so no band's records outlive it:
    counts holds the rays' own walk operations, the warps', the bands and
    the result."""
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    real, ms, ops = ws.render_linear_stream_ref, [], [0.0, 0.0]

    def band(*a, **k):
        with _Recorder(wfc, "scatter_bookkeep") as rec:
            t, out = _sync_ms(lambda: real(*a, **k))
        lane, warp = _k4_walk_ops(rec.calls, a, k["sub_bounds"], k["width"],
                                  out[0].shape[0], k["samples_per_pixel"])
        ms.append(t)
        ops[0], ops[1] = ops[0] + lane, ops[1] + warp
        return out
    ws.render_linear_stream_ref = band
    try:
        result = render()
    finally:
        ws.render_linear_stream_ref = real
    return sum(ms), dict(walk=ops[0], warp=ops[1], bands=len(ms),
                         result=result)


class _Recorder:
    """Records the arguments and result of every call of ``module.name``
    while active (the driver looks the function up at each call)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def record(*a, **k):
            out = self.real(*a, **k)
            self.calls.append((a, k, out))
            return out
        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)

    def replay_ms(self, runs=10):
        """Each recorded call's device time on its own inputs
        (``_replay_ms``)."""
        return [_replay_ms(self.real, a, k, runs) for a, k, _ in self.calls]


def _live_bytes(calls, module):
    """Bytes the recorded bounces of a per-bounce engine (K3 or K6, its
    ``module``) must move: each launch reads its tables and the camera
    once; each ray live at its start reads its state planes (none on the
    primary bounce, which makes its rays), writes them and, but after the
    last bounce, its sort key.  Dead rays and padding slots need nothing."""
    plane, total = 4 * module.P_STATE, 0
    for (T, cam_vec, state), k, _ in calls:
        if k["primary"]:
            live, reads = k["width"] * k["height"] * k["spp"], 0
        else:
            live, reads = int((state[module.ST_ALIVE] > 0.5).sum()), plane
        total += nbytes(tuple(T), cam_vec) + live * (
            reads + plane + (0 if k["is_last"] else 4))
    return total


def _k3_frame_timed(args, kw, **extra):
    """One K3 frame, then each of its passes and regroups again on the
    same inputs, timed by CUDA events: (pass ms, regroup ms, result, bytes
    the passes must move)."""
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    with _Recorder(wb, "binned_pass_cuda") as passes, \
            _Recorder(wb, "regroup") as regroups:
        result = wb.render_linear_binned(*args, **kw, **extra)
        pass_ms, regroup_ms = passes.replay_ms(), regroups.replay_ms()
    return pass_ms, regroup_ms, result, _live_bytes(passes.calls, wb)


def phase_mesh_throughput(rtt, smi, scenes, cli) -> dict:
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    dev = torch.device("cuda")
    log(f"\nmesh throughput on {smi}, {MESH_FULL}")
    out = {}
    for label, (scene, cam) in scenes.items():
        def run(seed, engine="auto"):
            return ops.render_linear_fast(scene, cam, device=dev, seed=seed,
                                          engine=engine, **MESH_FULL)
        sec, (_, segs) = _median_seconds(run)
        bad = ops.flush_binned_overflow_checks()
        k1_sec, (_, k1_segs) = _median_seconds(
            lambda seed: run(seed, "cuda"))
        log(f"  {label}: K3 frames {sec * 1e3:.3f} ms median, {segs} "
            f"segments -> {segs / sec:.6e} rays/s; K1 {k1_sec * 1e3:.3f} "
            f"ms -> {k1_segs / k1_sec:.6e} rays/s; overflowed frames {bad}")
        if bad:
            raise SystemExit(f"{label}: {bad} capped frames overflowed")
        args, kw = _binned_args(ops, tables, scene, cam, dev)
        caps = _caps(ops, scene, 512, 512)
        pass_ms, regroup_ms, capped, _ = _k3_frame_timed(
            args, dict(MESH_FULL, seed=1, **kw), bounce_caps=caps)
        whole = wb.render_linear_binned(*args, **MESH_FULL, seed=1, **kw)
        if capped[2] != 0 or not torch.equal(capped[0], whole[0]) \
                or capped[1] != whole[1]:
            raise SystemExit(f"{label}: the capped K3 frame (overflow "
                             f"{capped[2]}) is not the uncapped one")
        log(f"  {label}: capped K3 passes {[round(x, 3) for x in pass_ms]} "
            f"ms, regroups {[round(x, 3) for x in regroup_ms]} ms (caps "
            f"{caps} slots of {wb.tile_geometry(512, 512, 4)[4] * 128}); "
            f"the capped frame is bitwise the uncapped one")
        out[label] = dict(rays_per_s=segs / sec,
                          k1_rays_per_s=k1_segs / k1_sec, pass_ms=pass_ms,
                          regroup_ms=regroup_ms)

    # K3 and K4 against their plain versions at the API's full-width frame,
    # uncapped, with the kernels' times and bounds there
    scene, cam = scenes["OBJ-10k"]
    n_sph = scene.num_spheres
    log(f"\nK3 and K4 vs plain versions, OBJ-10k {API_SHAPE}")
    args, kw = _binned_args(ops, tables, scene, cam, dev)
    pass_ms, regroup_ms, k3, moved = _k3_frame_timed(
        args, dict(API_SHAPE, seed=1, **kw))
    # the plain versions' rays, live lanes and final hits count the node
    # and triangle tests of the bounds
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    with _Recorder(wb, "binned_pass_ref") as passes, \
            _Recorder(wfc, "sphere_hits") as hits:
        plain3_ms, p3 = _sync_ms(lambda: wb.render_linear_binned(
            *args, **API_SHAPE, seed=1, **kw, plain=True))
    err3 = compare_image("K3 OBJ-10k 512x288", k3, p3)
    walk3, warp3 = _k3_walk_ops(passes.calls, hits.calls)
    del passes, hits
    n_tops = args[5].shape[1]
    sel = (-(-n_tops // wb.SUPER) if n_tops >= wb.SUPER_MIN_TOPS else n_tops)
    b3 = bound(k3[1] * (n_sph * FLOPS_SPHERE + FLOPS_SHADE
                        + sel * FLOPS_BOX) + walk3, moved)
    log(f"  K3: passes {sum(pass_ms):.3f} ms "
        f"({[round(x, 3) for x in pass_ms]}), regroups "
        f"{sum(regroup_ms):.3f} ms, plain version {plain3_ms:.3f} ms; "
        f"bound {b3[0]:.4f} ms by {b3[1]} ({moved} bytes: tables, and "
        f"60 B in, 60 B out and a 4 B key for each ray live at a pass's "
        f"start; {walk3:.6e} "
        f"operations of the rays' own node and triangle tests; the warps "
        f"execute {warp3:.6e}, {warp3 / walk3:.2f}x: divergence), "
        f"{100 * b3[0] / sum(pass_ms):.2f}% of the passes' time")
    _, sargs, skw = ops._stream_call(scene, cam, dev, plain=False)
    ms4 = _event_ms(lambda: ws.render_linear_stream_cuda(
        *sargs, **API_SHAPE, seed=1, **skw))
    k4 = ws.render_linear_stream_cuda(*sargs, **API_SHAPE, seed=1, **skw)
    with _Recorder(wfc, "scatter_bookkeep") as rec:
        plain4_ms, p4 = _sync_ms(lambda: ws.render_linear_stream_ref(
            *sargs, **API_SHAPE, seed=1, **skw))
    err4 = compare_bitwise("K4 OBJ-10k 512x288", k4, p4)
    walk4, warp4 = _k4_walk_ops(rec.calls, sargs, skw["sub_bounds"],
                                API_SHAPE["width"], API_SHAPE["height"],
                                API_SHAPE["samples_per_pixel"])
    del rec
    tables4 = nbytes(sargs, skw["top_order"], skw["top_keys"],
                     skw["sub_bounds"])
    b4 = bound(k4[1] * (n_sph * FLOPS_SPHERE + FLOPS_SHADE) + walk4,
               tables4 + nbytes(k4[0]))
    log(f"  K4: {ms4:.3f} ms (CUDA events, median of 5), plain version "
        f"{plain4_ms:.3f} ms; bound {b4[0]:.4f} ms by {b4[1]} "
        f"({walk4:.6e} operations of the rays' own node and triangle "
        f"tests; the warps execute {warp4:.6e}, {warp4 / walk4:.2f}x), "
        f"{100 * b4[0] / ms4:.2f}% of K4's time")
    out.update(k3=dict(ms=sum(pass_ms), plain_ms=plain3_ms, err=err3,
                       bound=b3),
               k4_api=dict(ms=ms4, plain_ms=plain4_ms, err=err4, bound=b4))
    out["k4"] = _k4_cli_times(cli, tables4, n_sph)
    return out


def _k4_cli_times(cli, tables_bytes, n_sph) -> dict:
    """K4 at the CLI's frame (its scene, camera and seed; 512x287, 16 spp,
    depth 8): one launch of the whole frame, the 16 bands (each band's time
    too), the bound per band from phase 4c's count of that frame's walk,
    and the same with sub-leaf culling off (each sub-leaf given its leaf's
    bound): what the sub-leaf bounds buy."""
    from raytracer_tpu_torch import ops, rng
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    dev = torch.device("cuda")
    _, sargs, skw = ops._stream_call(cli["scene"], cli["cam"], dev,
                                     plain=False)
    shape = dict(width=512, height=287, samples_per_pixel=16, depth=8,
                 seed=rng.DEFAULT_SEED)
    band = -(-287 // 16)
    starts = range(0, 287, band)

    def timed(kw):
        one = _event_ms(lambda: ws.render_linear_stream_cuda(*sargs, **shape,
                                                             **kw))
        bands = _event_ms(lambda: [ws.render_linear_stream_cuda(
            *sargs, **shape, **kw, shard_rows=band, row_offset=r0)
            for r0 in starts])
        return one, bands

    one, bands = timed(skw)
    each = [_event_ms(lambda r0=r0: ws.render_linear_stream_cuda(
        *sargs, **shape, **skw, shard_rows=band, row_offset=r0), runs=3)
        for r0 in starts]
    off_one, off_bands = timed(dict(skw, sub_bounds=None))
    _profile_pass("K4's 16 bands of the CLI's frame", lambda: [
        ws.render_linear_stream_cuda(*sargs, **shape, **skw, shard_rows=band,
                                     row_offset=r0) for r0 in starts])
    n = len(starts)
    per = bound((cli["segs"] * (n_sph * FLOPS_SPHERE + FLOPS_SHADE)
                 + cli["walk"]) / n, tables_bytes + band * 512 * 16)
    log(f"  K4 at the CLI's frame {shape}: one launch {one:.3f} ms, {n} "
        f"bands {bands:.3f} ms ({bands / one:.2f}x one launch; "
        f"{bands / n:.3f} ms a band; each band "
        f"{[round(x, 3) for x in each]} ms); bound {per[0]:.4f} ms a band "
        f"by {per[1]} ({cli['walk']:.6e} operations of the rays' own node "
        f"and triangle tests over the frame; the warps execute "
        f"{cli['warp']:.6e}, {cli['warp'] / cli['walk']:.2f}x), "
        f"{100 * per[0] * n / bands:.2f}% of the bands' time; plain "
        f"version {cli['plain_ms'] / n:.3f} ms a band")
    log(f"  K4 without sub-leaf bounds (each sub-leaf takes its leaf's): "
        f"one launch {off_one:.3f} ms, {n} bands {off_bands:.3f} ms: the "
        f"sub-leaf bounds buy {off_one / one:.3f}x / {off_bands / bands:.3f}x")
    return dict(ms=bands / n, plain_ms=cli["plain_ms"] / n, bound=per,
                one_ms=one, bands_ms=bands, each_ms=each, off_one_ms=off_one,
                off_bands_ms=off_bands)


# ---------------------------------------------------------------------------
# the big-mesh gradient path: K2 and K5s (the two-level leaf walk)
# ---------------------------------------------------------------------------

STREAM_SMALL = dict(width=64, height=36, samples_per_pixel=2, depth=4, seed=3,
                    parity_plane_sign=False)
# bench.py:184-222: (fields, width, height, spp, depth)
MESH_GRAD = {"OBJ-10k": (["tri_v0", "mat_color"], 256, 256, 8, 4),
             "164k": (["tri_v0"], 256, 256, 4, 4)}


def _stream_tables(scene, cull, two_level=True):
    """``diff.walk_tables`` of ``scene`` over ``cull``, detached."""
    from raytracer_tpu_torch.ops import diff
    with torch.no_grad():
        return diff.walk_tables(scene, cull, two_level)


def phase_stream_vs_plain(rtt, scenes) -> dict:
    from raytracer_tpu_torch.ops import diff, tables
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    dev = torch.device("cuda")
    log(f"\nK2 and K5s vs plain versions at {STREAM_SMALL}")
    cases = {"OBJ-10k, 128-leaf topology (forced)": (
                 rtt.models.obj_mesh_scene(), 128),
             "164k, its own topology": (scenes["164k"], None)}
    out = {"err": {"K2": 0.0, "K5s": 0.0}, "plain_ms": {}}
    gen = torch.Generator(device=dev).manual_seed(4)
    for name, ((scene, cam), leaf) in cases.items():
        scene, cam = scene.to(dev), cam.to(dev)
        cull = diff.build_tri_cull(scene, leaf)
        t = _stream_tables(scene, cull)
        C, Ct = t["clusters"][0].shape[1], t["tops"][0].shape[1]
        S, T = t["sph"].shape[1], t["packed"].shape[1]
        log(f"  {name}: {C} leaves of <= "
            f"{int(max(np.diff(cull.ranges, axis=0)[0]))} triangles, "
            f"{Ct} tops, needs the two-level walk: "
            f"{diff._needs_stream(scene)}")
        cv = tables.camera_vec(cam)
        kw = dict(STREAM_SMALL, tri_clusters=t["clusters"])
        skw = dict(kw, tri_stream=t["tops"], sub_bounds=t["subs"])
        k2 = wfc.render_linear_cuda(t["sph"], t["aligned"], cv, **skw)
        p2_ms, p2 = _sync_ms(lambda: wfc.render_linear_ref(
            t["sph"], t["aligned"], cv, **skw))
        out["err"]["K2"] = max(out["err"]["K2"],
                               compare_image(f"K2 {name}", k2, p2))
        k1 = wfc.render_linear_cuda(t["sph"], t["packed"], cv, **kw)
        if not torch.equal(k1[0], k2[0]) or k1[1] != k2[1]:
            raise SystemExit(f"K2 {name}: not bitwise K1 over the same "
                             f"leaves")
        g = torch.randn(STREAM_SMALL["height"], STREAM_SMALL["width"], 3,
                        device=dev, generator=gen)
        gargs = (t["sph"], t["aligned"], g, cv)
        gkw = dict(skw, n_tris_packed=T)
        k5s = wb.grad_slab_cuda(*gargs, **gkw)
        p5_ms, p5 = _sync_ms(lambda: wb.grad_slab_ref(*gargs, **gkw))
        out["err"]["K5s"] = max(out["err"]["K5s"],
                                _hold_k5(f"K5s {name}", k5s, p5, S, T))
        k5 = wb.grad_slab_cuda(t["sph"], t["packed"], g, cv, **kw)
        if not (torch.equal(k5[0], k5s[0]) and torch.equal(k5[1], k5s[1])):
            raise SystemExit(f"K5s {name}: not bitwise K5 over the same "
                             f"leaves")
        out["plain_ms"][name] = (p2_ms, p5_ms)
        log(f"  {name}: K2 / K5s bitwise K1 / K5 over the same leaves "
            f"(image, {k2[1]} segments, slab, camera lanes); plain versions "
            f"K2 {p2_ms:.3f} ms, K5s {p5_ms:.3f} ms")
    return out


def _mesh_grad_setup(rtt, scene, cam, label):
    """bench.py's gradient configuration of ``label`` on the card: (loss
    function, start params, shape, target)."""
    from raytracer_tpu_torch import grad, ops
    fields, W, H, spp, depth = MESH_GRAD[label]
    shape = dict(width=W, height=H, samples_per_pixel=spp, depth=depth)
    with torch.no_grad():
        target, _ = ops.render_linear_fast(scene, cam, device=scene.device,
                                           seed=0, **shape)
    loss_fn = grad.make_loss_fn(scene, cam, target, seed=1,
                                parity_plane_sign=False, engine="pallas",
                                **shape)
    return loss_fn, grad.extract_params(scene, fields), shape, target


def _value_and_grad(loss_fn, start):
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    loss = loss_fn(params)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in params.items()}


def phase_mesh_grad(rtt, scenes) -> dict:
    from raytracer_tpu_torch import grad
    dev = torch.device("cuda")
    walks = {"OBJ-10k": ("K1", "K5"), "164k": ("K2", "K5s")}
    launches = {k: 0 for k in _counters()}
    out = {}
    for label, (fwd, bwd) in walks.items():
        scene, cam = (x.to(dev) for x in scenes[label])
        loss_fn, start, shape, _ = _mesh_grad_setup(rtt, scene, cam, label)
        log(f"\nmesh gradient path: {label} {shape}, params {list(start)}, "
            f"target seed 0, loss seed 1")
        _zero_counts()
        loss, grads = _value_and_grad(loss_fn, start)
        torch.cuda.synchronize()
        counts = _read_counts()
        log(f"  value and gradient: loss {float(loss):.9e}, launches "
            f"{counts}")
        if counts != _only(**{fwd: 1, bwd: 1}):
            raise SystemExit(f"{label} gradient pass: launches {counts}, "
                             f"expected one {fwd} and one {bwd}")
        for k, v in grads.items():
            if v is None or not torch.isfinite(v).all() or not v.any():
                raise SystemExit(f"{label} gradient pass: bad gradient for "
                                 f"{k}")
        # the fit interior gradients support: albedo from half of it
        p = {"mat_color": grad.extract_params(scene, ["mat_color"])[
            "mat_color"].mul(0.5).requires_grad_(True)}
        step = grad.make_train_step(loss_fn, torch.optim.Adam(p.values(),
                                                              lr=1e-2))
        _zero_counts()
        losses = [float(step(p)) for _ in range(3)]
        torch.cuda.synchronize()
        fit_counts = _read_counts()
        with torch.no_grad():
            final = float(loss_fn(p))
        log(f"  3 Adam steps at lr 1e-2 recovering mat_color from x0.5: "
            f"losses {losses}, after: {final:.9e}; launches {fit_counts}")
        if fit_counts != _only(**{fwd: 3, bwd: 3}):
            raise SystemExit(f"{label} fit: launches {fit_counts}")
        if not all(np.isfinite(losses + [final])) or not final < losses[0]:
            raise SystemExit(f"{label} fit: the loss did not fall "
                             f"({losses[0]} -> {final})")
        for k in (fwd, bwd):
            launches[k] += counts[k] + fit_counts[k]
        out[label] = dict(loss=float(loss), fit=(losses[0], final))
    out["launches"] = launches
    return out


def _k2_levels(t, subs):
    """K2's walk as _walk_ops levels, and the triangles of each node of the
    last level: top boxes, the leaf boxes of a passing top, then (with
    ``subs``, as K2 and K5s walk) the 32-column sub-leaf boxes of a passing
    leaf and a passing sub-leaf's columns, or (without) a passing leaf's
    packed count of columns.  Sub-leaves past a leaf's count are never
    voted."""
    (leafb, leafr), (topb, topr) = t["clusters"], t["tops"]
    n_leaves = leafb.shape[1]
    counts = leafr[1] - leafr[0]
    levels = [(_box_test(topb), None, FLOPS_BOX),
              (_box_test(leafb), _parents(topr, n_leaves), FLOPS_BOX)]
    if not subs:
        return levels, counts
    dev = leafb.device
    k = torch.arange(4, device=dev).repeat(n_leaves)
    sub_n = (counts.repeat_interleave(4) - 32 * k).clamp(0, 32)
    box = _box_test(t["subs"])
    levels.append((lambda ray, cull: box(ray, cull) & (sub_n > 0),
                   torch.arange(4 * n_leaves, device=dev) // 4, FLOPS_BOX))
    return levels, sub_n


def _one_level_plain(t, cv, kw):
    """K1's plain version over the packed table ``t`` with its triangle
    stage taken all columns at once (``wavefront.tri_block_hits``: the
    least t, ties to the last column, as the walk's visit order takes
    them; culling changes no hit): the one-level walk's image and hits at a
    gradient pass's full size, where the per-column loop of
    ``render_linear_ref`` would take minutes."""
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    tri = t["packed"]
    cols = torch.arange(tri.shape[1], device=tri.device)

    def stage(ray, h, alive, _b):
        sel = alive.nonzero()[:, 0]
        if sel.numel():
            rank = torch.full_like(alive, -1, dtype=torch.int64)
            wfc.tri_block_hits(tri, cols, ray, h, rank, 0, sel)
    return wfc.trace_pixels_ref(
        t["sph"], cv, stage, width=kw["width"], height=kw["height"],
        samples_per_pixel=kw["samples_per_pixel"], depth=kw["depth"],
        seed=kw["seed"], sph_clusters=None, shard_rows=kw["height"],
        row_offset=0, row_stride=1)


def _stream_kernels(scene, cam, label, start, shape, target, plain=False):
    """The forward and backward kernels of ``label``'s pass alone, at the
    pass's own topology, tables and image cotangent: event times, the
    reduction and the host glue (the tables the pass builds on each call);
    on the two-level walk K2 and K5s held bitwise against K1 and K5 over the
    packed table and the same leaves (image, segments, slab with its winner
    ids, camera lanes) and against their plain versions, with the plain
    versions' times, the walk's operations (with sub-leaves, and as counted
    before them) and the bounds; on the one-level walk with ``plain`` K1
    held against ``_one_level_plain``, and the walk's operations (leaf box
    and triangle tests, in K1's (pixel, sample) warps and in 8x4-pixel
    warps) and K1's and K5's bounds."""
    from raytracer_tpu_torch import grad
    from raytracer_tpu_torch.ops import diff, tables
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    cull = diff.build_tri_cull(scene)         # the loss's own, cached
    two = diff._needs_stream(scene)
    s = grad.apply_params(scene, start)
    glue_ms, t = _sync_ms(lambda: _stream_tables(s, cull, two))
    cv = tables.camera_vec(cam)
    S, T = t["sph"].shape[1], t["packed"].shape[1]
    one_kw = dict(shape, seed=1, parity_plane_sign=False,
                  tri_clusters=t["clusters"])
    if two:
        fargs = (t["sph"], t["aligned"], cv)
        kw = dict(one_kw, tri_stream=t["tops"], sub_bounds=t["subs"])
    else:
        fargs, kw = (t["sph"], t["packed"], cv), one_kw
    f_ms = _event_ms(lambda: wfc.render_linear_cuda(*fargs, **kw))
    img, kseg = wfc.render_linear_cuda(*fargs, **kw)
    g = (2.0 * (img - target) / img.numel()).contiguous()
    gkw = dict(kw, n_tris_packed=T) if two else kw
    b_ms = _event_ms(lambda: wb.grad_slab_cuda(fargs[0], fargs[1], g, cv,
                                               **gkw))
    slab, cam_l = wb.grad_slab_cuda(fargs[0], fargs[1], g, cv, **gkw)
    red_ms = _event_ms(lambda: wb.reduce_slab(slab, cam_l, S, T))
    # each lane-bounce's winner as a scene primitive (spheres, then
    # triangles by their index in the scene), whatever the topology
    win = slab[:, :, wb.GP_WIN].long()
    perm = torch.from_numpy(cull.perm).to(win.device)
    win = torch.where(win >= S, S + perm[(win - S).clamp_min(0)], win)
    out = dict(fwd_ms=f_ms, bwd_ms=b_ms, red_ms=red_ms, glue_ms=glue_ms,
               img=img, winners=win)
    log(f"  {label}: {'K2' if two else 'K1'} {f_ms:.3f} ms, "
        f"{'K5s' if two else 'K5'} {b_ms:.3f} ms, winner reduction onto "
        f"{S + T} rows {red_ms:.3f} ms (CUDA events, median of 5); host "
        f"glue (packers, leaf bounds"
        f"{', tops, sub-leaf boxes, aligned table' if two else ''}) "
        f"{glue_ms:.3f} ms")
    if not two:
        if plain:
            out.update(_one_level_bounds(t, cv, one_kw, img, kseg, g, slab,
                                         cam_l, f_ms, b_ms, label))
        return out
    k1 = wfc.render_linear_cuda(t["sph"], t["packed"], cv, **one_kw)
    k5 = wb.grad_slab_cuda(t["sph"], t["packed"], g, cv, **one_kw)
    if not (torch.equal(k1[0], img) and k1[1] == kseg
            and torch.equal(k5[0], slab) and torch.equal(k5[1], cam_l)):
        raise SystemExit(f"{label}: K2 / K5s not bitwise K1 / K5 over the "
                         f"same leaves")
    del k1, k5
    log(f"  {label}: K2 / K5s bitwise K1 / K5 over the same leaves (image, "
        f"{kseg} segments, slab and winner ids, camera lanes)")
    with _Recorder(wfc, "sphere_hits") as hits, \
            _Recorder(wfc, "scatter_bookkeep") as shades:
        p2_ms, p2 = _sync_ms(lambda: wfc.render_linear_ref(*fargs, **kw))
    out["k2_err"] = compare_image(f"K2 vs plain at {label} {shape}",
                                  (img, kseg), p2)
    levels, leaf_tris = _k2_levels(t, subs=True)
    walk, warp = _layout_walk_ops(shades.calls, levels, leaf_tris,
                                  shape["width"], shape["height"],
                                  shape["samples_per_pixel"])
    levels, leaf_tris = _k2_levels(t, subs=False)
    walk_old, warp_old = _pixel_walk_ops(hits.calls, levels, leaf_tris,
                                         shape["width"])
    del hits, shades
    p5_ms, p5 = _sync_ms(lambda: wb.grad_slab_ref(fargs[0], fargs[1], g, cv,
                                                  **gkw))
    out["k5s_err"] = _hold_k5(f"K5s vs plain at {label} {shape}",
                              (slab, cam_l), p5, S, T)
    tab = (t["sph"], t["aligned"], t["clusters"], t["tops"], t["subs"], cv)
    shading = kseg * (S * FLOPS_SPHERE + FLOPS_SHADE)
    b2 = bound(shading + walk, nbytes(*tab, img))
    b5 = bound(kseg * FLOPS_ADJOINT + 2 * shading + walk,
               nbytes(*tab, g, slab, cam_l))
    b2_old = bound(shading + walk_old, nbytes(*tab[:4], cv, img))
    log(f"  plain versions K2 {p2_ms:.3f} ms, K5s {p5_ms:.3f} ms; the walk "
        f"{walk:.6e} operations of the rays' own top, leaf and sub-leaf box "
        f"and triangle tests (the (pixel, sample) warps execute "
        f"{warp:.6e}, {warp / walk:.2f}x: divergence); counted without "
        f"sub-leaves {walk_old:.6e} (the 8x4-pixel warps "
        f"{warp_old / walk_old:.2f}x); bounds K2 {b2[0]:.4f} ms by {b2[1]} "
        f"({100 * b2[0] / f_ms:.2f}% of its time; without sub-leaves "
        f"{b2_old[0]:.4f} ms), K5s {b5[0]:.4f} ms by {b5[1]} "
        f"({100 * b5[0] / b_ms:.2f}%)")
    out.update(k2_plain_ms=p2_ms, k5s_plain_ms=p5_ms, k2_bound=b2,
               k5s_bound=b5)
    return out


def _one_level_bounds(t, cv, kw, img, kseg, g, slab, cam_l, f_ms, b_ms,
                      label) -> dict:
    """K1 against ``_one_level_plain`` at a pass's shape (bitwise but for
    exact triangle ties), and K1's and K5's bounds there: the spheres' tests
    and shading of each segment, and the leaf box and triangle tests of
    each live ray's own one-level walk (``_walk_ops``)."""
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    with _Recorder(wfc, "sphere_hits") as hits, \
            _Recorder(wfc, "scatter_bookkeep") as shades:
        p_ms, p1 = _sync_ms(lambda: _one_level_plain(t, cv, kw))
    err = compare_image(f"K1 vs plain at {label}", (img, kseg), p1)
    leafb, leafr = t["clusters"]
    levels = [(_box_test(leafb), None, FLOPS_BOX)]
    counts = leafr[1] - leafr[0]
    W, H, spp = kw["width"], kw["height"], kw["samples_per_pixel"]
    walk, warp = _layout_walk_ops(shades.calls, levels, counts, W, H, spp)
    _, warp_old = _pixel_walk_ops(hits.calls, levels, counts, W)
    del hits, shades
    S = t["sph"].shape[1]
    shading = kseg * (S * FLOPS_SPHERE + FLOPS_SHADE)
    tab = (t["sph"], t["packed"], t["clusters"], cv)
    b1 = bound(shading + walk, nbytes(*tab, img))
    b5 = bound(kseg * FLOPS_ADJOINT + 2 * shading + walk,
               nbytes(*tab, g, slab, cam_l))
    log(f"  {label}: plain version (triangles all columns at once) "
        f"{p_ms:.3f} ms; the walk {walk:.6e} operations of the rays' own "
        f"leaf box and triangle tests (the (pixel, sample) warps execute "
        f"{warp:.6e}, {warp / walk:.2f}x; 8x4-pixel warps "
        f"{warp_old / walk:.2f}x); bounds K1 {b1[0]:.4f} ms by {b1[1]} "
        f"({100 * b1[0] / f_ms:.2f}% of its time), K5 {b5[0]:.4f} ms by "
        f"{b5[1]} ({100 * b5[0] / b_ms:.2f}%)")
    return dict(k1_err=err, k1_plain_ms=p_ms, k1_bound=b1, k5_bound=b5)


def _profile_pass(label, fn) -> None:
    """One call of ``fn`` under torch.profiler: its wall time, the device's
    busy share (the kernels' summed durations: one stream, so they do not
    overlap) and the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # only the profiler's own setup and parsing are guarded: the pass runs
    # bare, so a failed launch or check in it fails the script
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:
        log(f"  {label} profile: not measured ({exc!r})")
        return
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    try:
        prof.stop()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
    except Exception as exc:
        log(f"  {label} profile: not measured ({exc!r})")
        return
    if not kernels:
        log(f"  {label} profile: the profiler saw no device time (not "
            f"measured)")
        return
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"  {label} profile (one pass under torch.profiler): wall "
        f"{wall:.3f} ms, {len(kernels)} kernel launches, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%); most device time: "
        + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top))


def phase_mesh_grad_throughput(rtt, smi, scenes) -> dict:
    from raytracer_tpu_torch.ops import diff
    dev = torch.device("cuda")
    log(f"\nmesh gradient throughput on {smi}")
    out = {}
    for label in MESH_GRAD:
        scene, cam = (x.to(dev) for x in scenes[label])
        loss_fn, start, shape, target = _mesh_grad_setup(rtt, scene, cam,
                                                         label)
        sec, _ = _median_seconds(lambda _: _value_and_grad(loss_fn, start))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        _value_and_grad(loss_fn, start)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        paths = shape["width"] * shape["height"] * shape["samples_per_pixel"]
        log(f"  {label} {shape}: value and gradient median {sec * 1e3:.3f} "
            f"ms -> {paths / sec:.6e} paths/s; peak device memory of the "
            f"pass {peak / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB "
            f"held before it")
        _profile_pass(label, lambda: _value_and_grad(loss_fn, start))
        out[label] = dict(paths_per_s=paths / sec, ms=sec * 1e3, peak=peak,
                          **_stream_kernels(scene, cam, label, start, shape,
                                            target, plain=True))
        rest = sec * 1e3 - sum(out[label][k] for k in ("fwd_ms", "bwd_ms",
                                                        "red_ms"))
        log(f"  {label}: the pass outside its two kernels and the reduction "
            f"{rest:.3f} ms ({100 * rest / (sec * 1e3):.1f}%)")
    # the walk crossover: each pass again through the other walk
    real = diff._needs_stream
    for label, leaf, forced in (("164k", diff.LEAF_SIZE, False),
                                ("OBJ-10k", diff.STREAM_LEAF_PAD, True)):
        scene, cam = (x.to(dev) for x in scenes[label])
        cull = diff.build_tri_cull(scene, leaf)
        diff._needs_stream = lambda s, f=forced: f
        try:
            loss_fn, start, shape, target = _mesh_grad_setup(rtt, scene,
                                                             cam, label)
            _zero_counts()
            _value_and_grad(loss_fn, start)
            torch.cuda.synchronize()
            counts = _read_counts()
            sec, _ = _median_seconds(lambda _: _value_and_grad(loss_fn,
                                                               start))
            log(f"  walk crossover, {label} through the other walk:")
            other = _stream_kernels(scene, cam, label, start, shape,
                                    target)
        finally:
            diff._needs_stream = real
        want = _only(K2=1, K5s=1) if forced else _only(K1=1, K5=1)
        if counts != want:
            raise SystemExit(f"crossover {label}: launches {counts}")
        paths = shape["width"] * shape["height"] * shape["samples_per_pixel"]
        walk = "two-level" if forced else "one-level"
        log(f"  walk crossover, {label} {walk} in {cull.ranges.shape[1]} "
            f"leaves of <= {leaf}: median {sec * 1e3:.3f} ms -> "
            f"{paths / sec:.6e} paths/s (its own walk: "
            f"{out[label]['ms']:.3f} ms; kernels "
            f"{other['fwd_ms']:.3f} + {other['bwd_ms']:.3f} ms against "
            f"{out[label]['fwd_ms']:.3f} + {out[label]['bwd_ms']:.3f} ms)")
        out[label]["other_walk_ms"] = sec * 1e3
        out[label]["other_err"] = (other.get("k2_err", 0.0),
                                   other.get("k5s_err", 0.0))
        # other leaves permute the columns: exact ties may resolve to
        # another triangle; count the lanes and pixels that moved
        d = (other["img"] - out[label]["img"]).abs().amax(dim=-1)
        moved = other["winners"] != out[label]["winners"]
        log(f"  {label}, the two topologies: {int(moved.sum())} of "
            f"{moved.numel()} lane-bounces took another winner, "
            f"{int((d > 0).sum())} of {d.numel()} pixels differ, max|diff| "
            f"{float(d.max()):.3e}")
    return out


# ---------------------------------------------------------------------------
# the sorted per-bounce engine K6, and K1-lowp (the bf16 sphere stage)
# ---------------------------------------------------------------------------

# the sorted engine's main-path frames: (A) an API session, (B) a call
SORTED_A = dict(width=512, height=512, samples_per_pixel=256, depth=4)
SORTED_B = dict(width=1024, height=1024, samples_per_pixel=32, depth=4)
LOWP_SMALL = dict(width=64, height=36, samples_per_pixel=4, depth=8, seed=3)
LOWP_FULL = dict(width=512, height=512, samples_per_pixel=64, depth=8)
# tests/test_pallas.py:246-251: two unit-scale spheres
UNIT_SCENE = ("camera origin 0.0 0.0 0.0 aspect 1.0;\n"
              "material M : Metal color 0.9 0.8 0.7 fuzz 0.1;\n"
              "material D : Diffuse color 0.4 0.6 0.3;\n"
              "sphere center -0.6 0.0 -1.6 radius 0.5 material M;\n"
              "sphere center 0.6 0.1 -1.4 radius 0.45 material D;\n")
# the unit scene with a third sphere: an odd count, so K1-lowp's packed
# table carries its padding sphere
THREE_SCENE = ("camera origin 0.0 0.0 0.0 aspect 1.0;\n"
               "material M : Metal color 0.9 0.8 0.7 fuzz 0.1;\n"
               "material D : Diffuse color 0.4 0.6 0.3;\n"
               "material G : Dielectric ir 1.5;\n"
               "sphere center -0.6 0.0 -1.6 radius 0.5 material M;\n"
               "sphere center 0.6 0.1 -1.4 radius 0.45 material D;\n"
               "sphere center 0.0 -0.3 -1.1 radius 0.2 material G;\n")
# K1-lowp's sphere test: 14 bfloat16 operations (centre difference, half_b,
# c) and 5 float32 ones (the discriminant, its root, the two roots); the
# bf16 ones counted at the H100 SXM's non-tensor bf16 peak, 2x float32
# (NVIDIA H100 architecture white paper)
FLOPS_SPHERE_BF16, FLOPS_SPHERE_LOWP_F32 = 14, 5
PEAK_BF16_SIMT = 133.8e12


def phase_sorted_vs_plain(rtt, scenes) -> dict:
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    dev = torch.device("cuda")
    log(f"\nK6 vs plain version at {MESH_SMALL}")
    out = {"worst": 0.0, "plain_ms": {}}
    cases = [(label, scene, cam, dict(
        MESH_SMALL, samples_per_pixel=2 if label == "164k" else 4))
        for label, (scene, cam) in scenes.items()]
    cases.append(("mesh-1292 37x21 (Morton padding), 3 spp",
                  *scenes["mesh-1292"],
                  dict(MESH_SMALL, width=37, height=21, samples_per_pixel=3)))
    for label, scene, cam, shape in cases:
        args, kw = _binned_args(ops, tables, scene, cam, dev)
        k = wso.render_linear_sorted(*args, **shape, **kw)
        pms, p = _sync_ms(lambda: wso.render_linear_sorted(
            *args, **shape, **kw, plain=True))
        out["worst"] = max(out["worst"], compare_image(f"K6 {label}", k, p))
        got = wso.render_linear_sorted(*args, **shape, **kw, node_exit=False)
        if not torch.equal(got[0], k[0]) or got[1] != k[1]:
            raise SystemExit(f"K6 {label}: node_exit off is not bitwise on")
        out["plain_ms"][label] = pms
        log(f"  {label}: node_exit off bitwise on; plain version "
            f"{pms:.3f} ms at spp {shape['samples_per_pixel']}")
    return out


def _lowp_worlds(rtt):
    return {"default world": rtt.models.default_world(),
            "unit scene": rtt.parse_input(UNIT_SCENE),
            "three spheres (odd count)": rtt.parse_input(THREE_SCENE)}


def _lowp_args(world, dev):
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    scene, cam = world.to_scene(), world.to_camera()
    sph, tri, _, _ = ops.scene_tables(scene, True, dev)
    return (sph, tri, tables.camera_vec(cam).to(dev)), scene.num_spheres


def phase_lowp_vs_plain(rtt) -> float:
    """K1-lowp bitwise its plain version (the packed bfloat16 stage rounds
    each operation as the plain version's torch bfloat16 ops do)."""
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    dev = torch.device("cuda")
    log(f"\nK1-lowp vs plain version at {LOWP_SMALL}, parity sign, "
        f"bitwise")
    worst = 0.0
    for name, world in _lowp_worlds(rtt).items():
        args, n_sph = _lowp_args(world, dev)
        kw = dict(LOWP_SMALL, parity_plane_sign=True, lowp=True)
        worst = max(worst, compare_bitwise(
            f"K1-lowp {name} ({n_sph} spheres)",
            wfc.render_linear_cuda(*args, **kw),
            wfc.render_linear_ref(*args, **kw)))
    return worst


def _seg_check(name, segs, k1_segs):
    gap = abs(segs - k1_segs) / k1_segs
    log(f"  {name}: segments {segs} vs K1's {k1_segs} ({100 * gap:.5f}%)")
    if gap > 1e-4:
        raise SystemExit(f"{name}: segments {segs} off K1's {k1_segs} by "
                         f"more than 0.01%")


def _peak_frame(fn):
    """(host ms, result, peak device memory above what was held) of one
    call of ``fn``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ms, result = _sync_ms(fn)
    return ms, result, torch.cuda.max_memory_allocated() - held, held


def phase_sorted_main_paths(rtt, scenes) -> dict:
    from raytracer_tpu_torch import api, ops
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    from raytracer_tpu_torch.render import finalize_image
    dev = torch.device("cuda")
    out = {"k6_launches": 0}
    # (A) an OBJ-10k session at 256 spp
    scene, cam = scenes["OBJ-10k"]
    opts = rtt.Options(samples_per_pixel=SORTED_A["samples_per_pixel"],
                       max_ray_bounces=SORTED_A["depth"])
    session = api.RenderSession.from_world(scene, cam, SORTED_A["width"],
                                           SORTED_A["height"], opts,
                                           device="cuda")
    engine = session.resolved_engine()
    log(f"\nsorted main path (A): RenderSession.from_world(OBJ-10k, "
        f"{SORTED_A}) resolves to {engine}")
    if engine != "cuda_sorted":
        raise SystemExit(f"(A) resolved to {engine}")
    _zero_counts()
    with _Recorder(wso, "render_linear_sorted") as rec:
        ms, fb, peak, held = _peak_frame(session.frame)
    counts = _read_counts()
    log(f"  (A) frame {ms:.3f} ms, launches {counts}; peak device memory "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held")
    if counts != _only(K6=SORTED_A["depth"]):
        raise SystemExit(f"(A): launches {counts}")
    out["k6_launches"] += counts["K6"]
    segs = rec.calls[0][2][1]
    del rec
    k1 = ops.render_linear_fast(scene, cam, device=dev, seed=opts.seed,
                                engine="cuda", **SORTED_A)
    _lsb_check("(A) session frame", fb, finalize_image(k1[0]).cpu().numpy())
    _seg_check("(A)", segs, k1[1])
    out["A"] = dict(ms=ms, peak=peak)
    del k1, fb
    # (B) the 164k scene at 1024x1024, 32 spp through render_linear_fast
    scene, cam = scenes["164k"]
    engine, _ = ops.resolve_dispatch(scene, None, "auto", dev,
                                     samples_per_pixel=32, width=1024,
                                     height=1024)
    log(f"\nsorted main path (B): render_linear_fast(164k, {SORTED_B}) "
        f"resolves to {engine}")
    if engine != "cuda_sorted":
        raise SystemExit(f"(B) resolved to {engine}")
    _zero_counts()
    ms, (mean, segs), peak, held = _peak_frame(lambda: ops.render_linear_fast(
        scene, cam, device=dev, seed=1, **SORTED_B))
    counts = _read_counts()
    log(f"  (B) frame {ms:.3f} ms, launches {counts}; peak device memory "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} GiB held")
    if counts != _only(K6=SORTED_B["depth"]) or not torch.isfinite(
            mean).all() or mean.shape != (1024, 1024, 3):
        raise SystemExit(f"(B): launches {counts}, shape {mean.shape}")
    out["k6_launches"] += counts["K6"]
    k1 = ops.render_linear_fast(scene, cam, device=dev, seed=1,
                                engine="cuda", **SORTED_B)
    _lsb_check("(B) frame", finalize_image(mean).cpu().numpy(),
               finalize_image(k1[0]).cpu().numpy())
    _seg_check("(B)", segs, k1[1])
    out["B"] = dict(ms=ms, peak=peak)
    return out


def phase_lowp_main_path(rtt) -> int:
    """The lowp study's frame through ``render_linear_cuda(lowp=True)``:
    one K1-lowp launch and nothing else."""
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    dev = torch.device("cuda")
    args, _ = _lowp_args(rtt.models.default_world(), dev)
    _zero_counts()
    img, segs = wfc.render_linear_cuda(*args, **LOWP_FULL, seed=1,
                                       parity_plane_sign=True, lowp=True)
    torch.cuda.synchronize()
    counts = _read_counts()
    log(f"\nK1-lowp main path: render_linear_cuda(lowp=True), default "
        f"world {LOWP_FULL}: {segs} segments, launches {counts}")
    if counts != _only(**{"K1-lowp": 1}) or not torch.isfinite(img).all():
        raise SystemExit(f"K1-lowp main path: launches {counts}")
    return counts["K1-lowp"]


def _k6_frame_timed(args, kw, runs=5):
    """One K6 frame, then each of its bounces, sorts and gathers and its
    image assembly again on the same inputs, timed by CUDA events: (bounce
    ms, regroup ms, assembly ms, result, bytes the bounces must move,
    [(slots launched, rays live) at each bounce's start])."""
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    with _Recorder(wso, "sorted_bounce_cuda") as bounces, \
            _Recorder(wb, "regroup") as regroups, \
            _Recorder(wso, "assemble_image") as assembly:
        result = wso.render_linear_sorted(*args, **kw)
        times = [r.replay_ms(runs) for r in (bounces, regroups, assembly)]
    slots = [(k["n_rays"], k["width"] * k["height"] * k["spp"])
             if k["primary"] else
             (state.shape[1], int((state[wso.ST_ALIVE] > 0.5).sum()))
             for (_, _, state), k, _ in bounces.calls]
    return (*times, result, _live_bytes(bounces.calls, wso), slots)


def _k6_plain_counted(args, kw):
    """K6's plain frame, each bounce timed alone (host clock between syncs)
    and its walk counted by _k6_walk_ops as soon as it returns, so no
    bounce's records outlive it: (bounce ms, result, the rays' own walk
    operations, the warps')."""
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    real, ms, ops = wso.sorted_bounce_ref, [], [0.0, 0.0]

    def bounce(*a, **k):
        with _Recorder(wfc, "sphere_hits") as hits:
            t, out = _sync_ms(lambda: real(*a, **k))
        lane, warp = _k6_walk_ops([(a, k, out)], hits.calls)
        ms.append(t)
        ops[0], ops[1] = ops[0] + lane, ops[1] + warp
        return out
    wso.sorted_bounce_ref = bounce
    try:
        result = wso.render_linear_sorted(*args, **kw, plain=True)
    finally:
        wso.sorted_bounce_ref = real
    return ms, result, ops[0], ops[1]


def _k6_walk_ops(bounces, hits):
    """_walk_ops summed over the recorded bounces of K6's plain version
    (sorted_bounce_ref calls and their sphere_hits calls): top, group and
    sub-leaf bounding spheres, warps of 32 consecutive sorted rays, the
    root-exit cap."""
    from raytracer_tpu_torch.ops import tables as tb
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    lane = warp = 0.0
    for (pa, _, _), (ha, _, h) in zip(bounces, hits):
        T, ray, alive = pa[0], ha[2], ha[3]
        levels = [(_sphere_test(T.topb), None, FLOPS_BOUND),
                  (_sphere_test(T.grpb), _parents(T.topr, T.grpb.shape[1]),
                   FLOPS_BOUND),
                  (_sphere_test(T.subb), torch.arange(
                      T.subb.shape[1], device=alive.device) // tb.GROUP_SUBS,
                   FLOPS_BOUND)]
        cap = wb.root_cap(T.root, ray, alive)
        n = alive.shape[0]
        wid = torch.arange(n, device=alive.device) // WARP
        r, w = _walk_ops(ray, alive, torch.minimum(h[0], cap), wid,
                         n // WARP, levels, T.subn[0])
        lane, warp = lane + r, warp + w
    return lane, warp


def _psnr(a, b):
    mse = float(((a - b) ** 2).mean())
    peak = max(float(a.max()), 1e-6)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def phase_sorted_throughput(rtt, smi, scenes) -> dict:
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    dev = torch.device("cuda")
    log(f"\nsorted engine throughput on {smi}")
    out = {}
    for label, key, shape in (("(A) OBJ-10k", "OBJ-10k", SORTED_A),
                              ("(B) 164k", "164k", SORTED_B)):
        scene, cam = scenes[key]

        def run(seed, engine="auto", scene=scene, cam=cam, shape=shape):
            return ops.render_linear_fast(scene, cam, device=dev, seed=seed,
                                          engine=engine, **shape)
        sec, (_, segs) = _median_seconds(run, runs=3)
        k1_sec, (_, k1_segs) = _median_seconds(lambda s: run(s, "cuda"),
                                               runs=3)
        log(f"  {label} {shape}: K6 frames {sec * 1e3:.3f} ms median of 3, "
            f"{segs} segments -> {segs / sec:.6e} rays/s; K1 "
            f"{k1_sec * 1e3:.3f} ms -> {k1_segs / k1_sec:.6e} rays/s "
            f"({k1_sec / sec:.3f}x)")
        _profile_pass(label, lambda: run(1))
        args, kw = _binned_args(ops, tables, scene, cam, dev)
        b_ms, g_ms, a_ms, k6, moved, slots = _k6_frame_timed(
            args, dict(shape, seed=1, **kw))
        _, n_rays = wso.ray_layout(shape["width"], shape["height"],
                                   shape["samples_per_pixel"])
        log(f"  {label}: K6 bounces {[round(x, 3) for x in b_ms]} ms, sort "
            f"+ gather {[round(x, 3) for x in g_ms]} ms (the prefix live "
            f"at each bounce's start), image assembly {a_ms[0]:.3f} ms "
            f"(CUDA events, replayed 5x); {n_rays} ray slots; (slots "
            f"launched, rays live) at each bounce's start {slots}")
        out[key] = dict(rays_per_s=segs / sec, k1_rays_per_s=k1_segs / k1_sec,
                        ms=sec * 1e3, bounce_ms=b_ms, regroup_ms=g_ms,
                        assembly_ms=a_ms[0], slots=slots)
        if shape is SORTED_A:
            k6_a, moved_a = k6, moved
        del k6

    # the crossover K6 against K1 under SORTED_MIN_TRIS, and K6 against K3
    def frame_sec(scene, cam, engine, shape):
        return _median_seconds(lambda s: ops.render_linear_fast(
            scene, cam, device=dev, seed=s, engine=engine, **shape), runs=3)
    scene, cam = scenes["mesh-1292"]
    k6_sec, (_, k6_segs) = frame_sec(scene, cam, "cuda_sorted", SORTED_B)
    k1_sec, (_, k1_segs) = frame_sec(scene, cam, "cuda", SORTED_B)
    log(f"  crossover, mesh-1292 {SORTED_B}: K6 {k6_sec * 1e3:.3f} ms -> "
        f"{k6_segs / k6_sec:.6e} rays/s, K1 {k1_sec * 1e3:.3f} ms -> "
        f"{k1_segs / k1_sec:.6e} rays/s (SORTED_MIN_TRIS "
        f"{ops.SORTED_MIN_TRIS})")
    out["crossover"] = (k6_segs / k6_sec, k1_segs / k1_sec)
    out["vs_k3"] = {}
    for label, (scene, cam) in scenes.items():
        k6_sec, (_, k6_segs) = frame_sec(scene, cam, "cuda_sorted",
                                         MESH_FULL)
        k3_sec, (_, k3_segs) = frame_sec(scene, cam, "cuda_binned",
                                         MESH_FULL)
        log(f"  {label} {MESH_FULL}: K6 {k6_sec * 1e3:.3f} ms -> "
            f"{k6_segs / k6_sec:.6e} rays/s, K3 {k3_sec * 1e3:.3f} ms -> "
            f"{k3_segs / k3_sec:.6e} rays/s")
        out["vs_k3"][label] = (k6_segs / k6_sec, k3_segs / k3_sec)
    if ops.flush_binned_overflow_checks():
        raise SystemExit("capped K3 frames overflowed")

    # K6 against its plain version at (A), the main path's frame past 2^24
    # rays, with both versions' bounce times and K6's bound there
    scene, cam = scenes["OBJ-10k"]
    n_sph = scene.num_spheres
    log(f"\nK6 vs plain version at (A), OBJ-10k {SORTED_A}")
    args, kw = _binned_args(ops, tables, scene, cam, dev)
    p_ms, p6, walk, warp = _k6_plain_counted(args, dict(SORTED_A, seed=1,
                                                        **kw))
    err = compare_bitwise("K6 (A)", k6_a, p6)
    del p6
    b_ms = out["OBJ-10k"]["bounce_ms"]
    b6 = bound(k6_a[1] * (n_sph * FLOPS_SPHERE + FLOPS_SHADE) + walk,
               moved_a)
    log(f"  K6: bounces {sum(b_ms):.3f} ms ({[round(x, 3) for x in b_ms]}), "
        f"plain version's bounces {sum(p_ms):.3f} ms "
        f"({[round(x, 1) for x in p_ms]}); bound {b6[0]:.4f} ms by {b6[1]} "
        f"({moved_a} bytes: tables, and 56 B in, 56 B out and a 4 B key for "
        f"each ray live at a bounce's start; {walk:.6e} operations of the "
        f"rays' own node and triangle tests; the warps execute "
        f"{warp:.6e}, {warp / walk:.2f}x: divergence), "
        f"{100 * b6[0] / sum(b_ms):.2f}% of the bounces' time")
    out["k6"] = dict(ms=sum(b_ms), plain_ms=sum(p_ms), err=err, bound=b6)

    # K1-lowp against K1 at the lowp study's frame (parity sign, as
    # scripts/perf_study.py:342-346)
    args, n_sph = _lowp_args(rtt.models.default_world(), dev)
    kw = dict(LOWP_FULL, seed=1, parity_plane_sign=True)
    f32_ms = _event_ms(lambda: wfc.render_linear_cuda(*args, **kw))
    low_ms = _event_ms(lambda: wfc.render_linear_cuda(*args, **kw,
                                                      lowp=True))
    f32, _ = wfc.render_linear_cuda(*args, **kw)
    low, lseg = wfc.render_linear_cuda(*args, **kw, lowp=True)
    plain_ms, plain = _sync_ms(lambda: wfc.render_linear_ref(*args, **kw,
                                                             lowp=True))
    err = compare_bitwise(f"K1-lowp vs plain at {LOWP_FULL}", (low, lseg),
                          plain)
    b = bound(lseg * (n_sph * (FLOPS_SPHERE_LOWP_F32 + FLOPS_SPHERE_BF16
                               * PEAK_FLOPS / PEAK_BF16_SIMT)
                      + FLOPS_SHADE),
              nbytes(*args, wfc.lowp_sphere_table(args[0]), low))
    log(f"  K1-lowp {low_ms:.3f} ms against K1 {f32_ms:.3f} ms "
        f"({f32_ms / low_ms:.3f}x; CUDA events, median of 5), plain version "
        f"{plain_ms:.3f} ms; PSNR against float32 "
        f"{_psnr(f32, low):.3f} dB; bound {b[0]:.4f} ms by {b[1]}")
    out["lowp"] = dict(ms=low_ms, plain_ms=plain_ms, err=err, bound=b)
    return out


# ---------------------------------------------------------------------------
# old against new: K4's and K6's times for the port in any checkout
# ---------------------------------------------------------------------------

def _cli_frame(rtt, scene):
    """The CLI's obj= frame of ``scene``'s triangles: the scene as the CLI
    parses it from an OBJ file, and the CLI's camera."""
    import math
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.models import obj as obj_mod
    h = scene.numpy()
    tris = [(tuple(h.tri_v0[i]), tuple(h.tri_v1[i]), tuple(h.tri_v2[i]),
             int(h.tri_mat[i])) for i in np.nonzero(h.tri_valid)[0]]
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "obj10k.obj"
        path.write_text(obj_mod.dump_obj(tris))
        cli_scene = cli._obj_scene(str(path))
    return cli_scene, rtt.Camera.new_look_at(
        (0.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), math.pi / 2.0,
        1.77778)


def _sha(t) -> str:
    return hashlib.sha256(
        t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _pass_kernels(loss_fn, start, runs=10):
    """One value and gradient of ``loss_fn`` at ``start`` with its forward
    and backward kernel calls recorded (``_pass_calls``): each call's device
    time replayed on its own inputs (CUDA events), and the calls (args,
    kwargs, outputs)."""
    calls = _pass_calls(loss_fn, start)
    with torch.no_grad():
        return (*(_replay_ms(fn, a, k, runs) for fn, a, k, _ in calls),
                *(c[1:] for c in calls))


def _replay_ms(fn, a, k, runs=10):
    """Device time of ``fn(*a, **k)``: CUDA events around ``runs``
    back-to-back calls after one more, so host time hides behind the
    queue."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn(*a, **k)
    start.record()
    for _ in range(runs):
        fn(*a, **k)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def k1_k5_calls(rtt) -> dict:
    """The main path's K1 and K5 calls, recorded through entry points every
    version of the port has (``cli.main``, ``render_linear_cuda``,
    ``grad_slab_cuda``): {"headline": [K1], "lowp study": [K1-lowp],
    "CLI bands": 16 x [K1], "default-world pass": [K1, K5], "OBJ-10k
    pass": [K1, K5]}, each call
    (function, args, kwargs, outputs); with "fb" the CLI framebuffer's
    sha256 and "obj10k" the OBJ-10k pass's median time.  The CLI's bands
    are held bitwise against the rows of one whole-frame call."""
    from raytracer_tpu_torch import cli, ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    dev = torch.device("cuda")
    out = {}
    w = rtt.models.default_world()
    scene, cam = w.to_scene(), w.to_camera()
    sph, tri, scl, tcl = ops.scene_tables(scene, True, dev)
    cv = tables.camera_vec(cam).to(dev)
    kw = dict(width=512, height=512, samples_per_pixel=64, depth=8, seed=1,
              parity_plane_sign=True, sph_clusters=scl, tri_clusters=tcl)
    out["headline"] = [(wfc.render_linear_cuda, (sph, tri, cv), kw,
                        wfc.render_linear_cuda(sph, tri, cv, **kw))]
    args, _ = _lowp_args(w, dev)
    kw = dict(LOWP_FULL, seed=1, parity_plane_sign=True, lowp=True)
    out["lowp study"] = [(wfc.render_linear_cuda, args, kw,
                          wfc.render_linear_cuda(*args, **kw))]
    with tempfile.TemporaryDirectory() as tmp:
        ppm = Path(tmp) / "image.ppm"
        with _Recorder(wfc, "render_linear_cuda") as bands:
            rc = cli.main(["samples=64", "ray_depth=8", "width=512",
                           f"out={ppm}"])
        out["fb"] = hashlib.sha256(ppm.read_bytes()).hexdigest()
    if rc != 0 or len(bands.calls) != 16:
        raise SystemExit(f"the CLI: rc {rc}, {len(bands.calls)} K1 calls")
    out["CLI bands"] = [(bands.real, a, k, o) for a, k, o in bands.calls]
    a, k, _ = bands.calls[0]
    whole = dict(k)
    del whole["shard_rows"], whole["row_offset"]
    mean, segs = bands.real(*a, **whole)
    for _, _, k, (m, _) in out["CLI bands"]:
        r0, n = k["row_offset"], min(k["shard_rows"], k["height"] - k[
            "row_offset"])
        if not torch.equal(m[:n], mean[r0:r0 + n]):
            raise SystemExit(f"the CLI band at row {r0} is not the whole "
                             f"frame's rows")
    if sum(o[1] for _, _, _, o in out["CLI bands"]) != segs:
        raise SystemExit("the CLI bands' segments are not the whole "
                         "frame's")
    _, _, _, loss_fn, start = _bench_grad(rtt)
    out["default-world pass"] = _pass_calls(loss_fn, start)
    scene, cam = (x.to(dev) for x in rtt.models.obj_mesh_scene())
    loss_fn, start, shape, _ = _mesh_grad_setup(rtt, scene, cam, "OBJ-10k")
    sec, _ = _median_seconds(lambda _: _value_and_grad(loss_fn, start))
    out["obj10k"] = dict(pass_ms=sec * 1e3, paths_per_s=shape["width"]
                         * shape["height"] * shape["samples_per_pixel"]
                         / sec)
    out["OBJ-10k pass"] = _pass_calls(loss_fn, start)
    return out


def _pass_calls(loss_fn, start):
    """One value and gradient's forward and backward kernel calls."""
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    with _Recorder(wfc, "render_linear_cuda") as fwd, \
            _Recorder(wb, "grad_slab_cuda") as bwd:
        _value_and_grad(loss_fn, start)
    torch.cuda.synchronize()
    if len(fwd.calls) != 1 or len(bwd.calls) != 1:
        raise SystemExit(f"a gradient pass made {len(fwd.calls)} forward "
                         f"and {len(bwd.calls)} backward kernel calls")
    return [(fwd.real, *fwd.calls[0]), (bwd.real, *bwd.calls[0])]


def _digest(outs) -> dict:
    """Hashes of K1's (image, segments) and K5's (slab with its zeros as
    +0, camera lanes) outputs; ``slab_raw`` the slab's own bytes."""
    if len(outs) == 2 and isinstance(outs[1], int):
        return dict(img=_sha(outs[0]), segs=outs[1])
    return dict(slab=_sha(outs[0] + 0.0), slab_raw=_sha(outs[0]),
                cam=_sha(outs[1]))


# the shapes of k1_k5_calls
K1_K5_SHAPES = ("headline", "lowp study", "CLI bands", "default-world pass",
                "OBJ-10k pass")


def time_k1_k5(calls, runs=10) -> dict:
    """Each recorded K1 / K5 call of ``k1_k5_calls`` replayed (device ms)
    and its outputs recomputed and hashed: {shape: {"ms": [...],
    "digest": [...]}}; the CLI bands' digest is of all 16 bands' images
    and their segments."""
    out = {}
    for name in K1_K5_SHAPES:
        ms, digest = [], []
        for fn, a, k, _ in calls[name]:
            ms.append(_replay_ms(fn, a, k, runs))
            digest.append(_digest(fn(*a, **k)))
        if name == "CLI bands":
            digest = [dict(img=hashlib.sha256("".join(
                d["img"] for d in digest).encode()).hexdigest(),
                segs=sum(d["segs"] for d in digest))]
        out[name] = dict(ms=ms, digest=digest)
    return out


def measure_grad_times(rtt) -> dict:
    """K1 at the headline frame and the CLI's 16 bands, K1-lowp at its study
    frame, K1 and K5 at the default world's and OBJ-10k's gradient passes, and the 164k gradient
    pass with its K2 and K5s, for ``--times``: their calls recorded and
    replayed, their outputs hashed (the slabs with their zeros as +0; the
    raw bytes in ``slab_raw``: a lane dead at a bounce writes 0 x its stale
    hit's gradients, whose sign of zero follows whichever hit its warp's
    walk left it, and no reader of the slab tells -0 from +0), the CLI's
    framebuffer hashed."""
    dev = torch.device("cuda")
    calls = k1_k5_calls(rtt)
    out = dict(k1k5=time_k1_k5(calls), fb=calls["fb"], obj10k=calls["obj10k"])
    t = out["k1k5"]
    log(f"  K1 headline {t['headline']['ms'][0]:.3f} ms; K1-lowp at its "
        f"study frame {t['lowp study']['ms'][0]:.3f} ms; CLI 16 bands "
        f"{sum(t['CLI bands']['ms']):.3f} ms; default-world pass K1 "
        f"{t['default-world pass']['ms'][0]:.3f} ms, K5 "
        f"{t['default-world pass']['ms'][1]:.3f} ms; OBJ-10k pass "
        f"{calls['obj10k']['pass_ms']:.3f} ms "
        f"({calls['obj10k']['paths_per_s']:.6e} paths/s), K1 "
        f"{t['OBJ-10k pass']['ms'][0]:.3f} ms, K5 "
        f"{t['OBJ-10k pass']['ms'][1]:.3f} ms")
    del calls
    scene, cam = (x.to(dev) for x in big_mesh_scene(rtt))
    loss_fn, start, shape, _ = _mesh_grad_setup(rtt, scene, cam, "164k")
    sec, _ = _median_seconds(lambda _: _value_and_grad(loss_fn, start))
    k2_ms, k5s_ms, (_, _, (img, kseg)), (_, _, (slab, cam_l)) = \
        _pass_kernels(loss_fn, start)
    paths = shape["width"] * shape["height"] * shape["samples_per_pixel"]
    out["164k"] = dict(pass_ms=sec * 1e3, paths_per_s=paths / sec,
                       k2_ms=k2_ms, k5s_ms=k5s_ms, segs=kseg,
                       img_hash=_sha(img), slab_hash=_sha(slab + 0.0),
                       slab_raw_hash=_sha(slab), cam_hash=_sha(cam_l))
    log(f"  164k gradient pass {shape}: median {sec * 1e3:.3f} ms -> "
        f"{paths / sec:.6e} paths/s; K2 {k2_ms:.3f} ms, K5s {k5s_ms:.3f} ms "
        f"(its own calls replayed, CUDA events); image "
        f"{out['164k']['img_hash'][:16]}, slab "
        f"{out['164k']['slab_hash'][:16]}, camera lanes "
        f"{out['164k']['cam_hash'][:16]}")
    return out


def measure_k4_k6(rtt, smi) -> dict:
    """K4's and K6's times on their main paths, with only the entry points
    that every version of the port has, so the same code times an older
    checkout (``--times``): K4 at the CLI's obj= frame (one launch, the 16
    bands) and at OBJ-10k 512x288, 4 spp, depth 4; the (A) and (B) frames
    (median of 3), their bounces, sorts + gathers and assembly (CUDA
    events), the slots each bounce launched, peak memory, and a hash of
    each framebuffer."""
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    dev = torch.device("cuda")
    scenes = mesh_scenes(rtt)
    out = {"gpu": smi}
    cli_scene, cli_cam = _cli_frame(rtt, scenes["OBJ-10k"][0])
    shape = dict(width=512, height=287, samples_per_pixel=16, depth=8,
                 seed=rtt.rng.DEFAULT_SEED)
    _, sargs, skw = ops._stream_call(cli_scene, cli_cam, dev, plain=False)
    one = _event_ms(lambda: ws.render_linear_stream_cuda(*sargs, **shape,
                                                         **skw))
    bands = _event_ms(lambda: [ws.render_linear_stream_cuda(
        *sargs, **shape, **skw, shard_rows=18, row_offset=r0)
        for r0 in range(0, 287, 18)])
    frame = ws.render_linear_stream_cuda(*sargs, **shape, **skw)
    scene, cam = scenes["OBJ-10k"]
    _, sargs, skw = ops._stream_call(scene, cam, dev, plain=False)
    api = _event_ms(lambda: ws.render_linear_stream_cuda(
        *sargs, **API_SHAPE, seed=1, **skw))
    # the CLI's shape with OBJ-10k's own camera and seed 1, as phase 5c
    # timed it before it took the CLI's own frame
    shape = dict(shape, seed=1)
    own_one = _event_ms(lambda: ws.render_linear_stream_cuda(*sargs, **shape,
                                                             **skw))
    own_bands = _event_ms(lambda: [ws.render_linear_stream_cuda(
        *sargs, **shape, **skw, shard_rows=18, row_offset=r0)
        for r0 in range(0, 287, 18)])
    out["k4"] = dict(cli_one_ms=one, cli_bands_ms=bands, api_ms=api,
                     own_one_ms=own_one, own_bands_ms=own_bands,
                     cli_segs=frame[1], cli_hash=hashlib.sha256(
                         frame[0].cpu().numpy().tobytes()).hexdigest())
    log(f"  K4 CLI frame: one launch {one:.3f} ms, 16 bands {bands:.3f} ms; "
        f"the CLI's shape with OBJ-10k's camera: one launch {own_one:.3f} "
        f"ms, 16 bands {own_bands:.3f} ms; OBJ-10k 512x288, 4 spp, depth 4: "
        f"{api:.3f} ms")
    for label, key, fshape in (("A", "OBJ-10k", SORTED_A),
                               ("B", "164k", SORTED_B)):
        scene, cam = scenes[key]

        def run(seed, scene=scene, cam=cam, fshape=fshape):
            return ops.render_linear_fast(scene, cam, device=dev, seed=seed,
                                          **fshape)
        sec, _ = _median_seconds(run, runs=3)
        ms, (mean, segs), peak, _ = _peak_frame(lambda: run(1))
        digest = hashlib.sha256(mean.cpu().numpy().tobytes()).hexdigest()
        del mean
        args, kw = _binned_args(ops, tables, scene, cam, dev)
        b_ms, g_ms, a_ms, res, _, slots = _k6_frame_timed(
            args, dict(fshape, seed=1, **kw), runs=3)
        del res
        out[label] = dict(frame_ms=sec * 1e3, rays_per_s=segs / sec,
                          segs=segs, bounce_ms=b_ms, regroup_ms=g_ms,
                          assembly_ms=a_ms[0], slots=slots, peak=peak,
                          hash=digest)
        log(f"  ({label}) frame {sec * 1e3:.3f} ms, {segs / sec:.6e} rays/s, "
            f"{segs} segments; bounces {[round(x, 3) for x in b_ms]} "
            f"= {sum(b_ms):.3f} ms, sorts + gathers "
            f"{[round(x, 3) for x in g_ms]} ms, assembly {a_ms[0]:.3f} ms; "
            f"(slots, live) {slots}; peak {peak / 2**30:.3f} GiB; "
            f"framebuffer sha256 {digest[:16]}")
    return out


def measure_k3(rtt) -> dict:
    """K3's times on its main path, with only the entry points every
    version of the port has (``ops.render_linear_fast``,
    ``wavefront_binned.render_linear_binned``), for ``--times``: the warm
    capped frames of phase 5c (mesh-1292, OBJ-10k and 164k at 512x512, 4
    spp, depth 4: median of 5, after the probe) and the API session's
    OBJ-10k frame (512x288, 4 spp, depth 4, the session's seed), each
    frame's passes and regroups by CUDA events (the capped frame at seed 1
    replayed), and a hash of each image with its segment count."""
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    dev = torch.device("cuda")
    out = {}
    for label, scene, cam, shape in _k3_frames(rtt):
        seed0 = rtt.Options().seed if shape is API_SHAPE else 0

        def run(seed, scene=scene, cam=cam, shape=shape, seed0=seed0):
            return ops.render_linear_fast(scene, cam, device=dev,
                                          seed=seed0 + seed, **shape)
        sec, _ = _median_seconds(run)
        seed_img, seed_segs = run(0)
        bad = ops.flush_binned_overflow_checks()
        args, kw = _binned_args(ops, tables, scene, cam, dev)
        caps = _caps(ops, scene, shape["width"], shape["height"])
        pass_ms, regroup_ms, (mean, segs, over), _ = _k3_frame_timed(
            args, dict(shape, seed=1, **kw), bounce_caps=caps)
        if bad or over:
            raise SystemExit(f"K3 {label}: {bad} overflowed frames, the "
                             f"capped frame dropped {over} rays")
        out[label] = dict(frame_ms=sec * 1e3, rays_per_s=segs / sec,
                          pass_ms=pass_ms, regroup_ms=regroup_ms,
                          caps=list(caps), hash=_sha(mean), segs=segs,
                          frame_hash=_sha(seed_img), frame_segs=seed_segs)
        log(f"  K3 {label} {shape}: frame {sec * 1e3:.3f} ms median of 5 "
            f"(capped, after the probe), {segs / sec:.6e} rays/s; passes "
            f"{[round(x, 3) for x in pass_ms]} = {sum(pass_ms):.3f} ms, "
            f"regroups {[round(x, 3) for x in regroup_ms]} = "
            f"{sum(regroup_ms):.3f} ms (CUDA events, replayed); image "
            f"{out[label]['hash'][:16]}, {segs} segments")
    return out


# the staging study: K4 and K6 with their tile fills skipped and the
# staged test reading the table instead (path_common.cuh patched in a copy
# of csrc/ under build/): every vote, mask and re-vote as shipped
UNSTAGED_PATCHES = (
    ("""  const unsigned dst = (unsigned)__cvta_generic_to_shared(tile) +""",
     """  return;
  const unsigned dst = (unsigned)__cvta_generic_to_shared(tile) +"""),
    ("""  const float4 *q =""",
     """  tri_step<PARITY, TRACK>(tri, nt, ti, r, h, win);
  return;
  const float4 *q ="""),
)


def _study_lib(name, patches):
    """The kernels built from a copy of csrc/ (under build/) with
    ``patches``: {file name: ((old, new), ...)}, each old text found once."""
    import shutil
    from raytracer_tpu_torch.ops.cuda import build
    study = ROOT / "build" / name / "csrc"
    if study.exists():
        shutil.rmtree(study)
    shutil.copytree(build.CSRC_DIR, study)
    for fname, pairs in patches.items():
        src = (study / fname).read_text()
        for a, b in pairs:
            if src.count(a) != 1:
                raise SystemExit(f"{name}: cannot patch {a!r}")
            src = src.replace(a, b)
        (study / fname).write_text(src)
    return build.load(study)


def _unstaged_lib():
    """The kernels with UNSTAGED_PATCHES."""
    return _study_lib("unstaged_study",
                      {"path_common.cuh": UNSTAGED_PATCHES})


# the K3 study: the dead-warp skip off (every warp takes the closest hit)
K3_NO_SKIP = ("  if (__any_sync(FULL_MASK, alive)) {\n    sphere_hits(",
              "  if (true) {\n    sphere_hits(")
# the K1-lowp study: its sphere stage as per-operation conversions (each
# bfloat16 operation a float32 one rounded through a bfloat16 conversion
# and back, one sphere at a time from the float32 table), and as scalar
# native bfloat16 instructions (one sphere an instruction, from the packed
# table)
LOWP_PAIRS = """\
    const int pairs = (n_sph + 1) >> 1;
    for (int k = 0; k < pairs; ++k)
      sphere_pair_lowp(spl, sph, n_sph, k, o2, d2, h);"""
# the study stages go just before the sphere stage in path_common.cuh
LOWP_ANCHOR = "// closest sphere hit (common.rs:60-98)"
LOWP_BF16R_STAGE = """\
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void sphere_step_lowp(const float *__restrict__ sph,
                                                 int ns, int si, const Ray &rl,
                                                 Hit &h) {
  const float cx = sph[SPH_CX * ns + si];
  const float cy = sph[SPH_CY * ns + si];
  const float cz = sph[SPH_CZ * ns + si];
  const float r2 = sph[SPH_R2 * ns + si];
  const float ocx = bf16r(rl.ox - bf16r(cx));
  const float ocy = bf16r(rl.oy - bf16r(cy));
  const float ocz = bf16r(rl.oz - bf16r(cz));
  const float half_b = bf16r(bf16r(bf16r(ocx * rl.dx) + bf16r(ocy * rl.dy)) +
                             bf16r(ocz * rl.dz));
  const float cc = bf16r(bf16r(bf16r(bf16r(ocx * ocx) + bf16r(ocy * ocy)) +
                               bf16r(ocz * ocz)) -
                         bf16r(r2));
  sphere_root_lowp(sph, ns, si, half_b, cc, r2 > 0.0f ? 0.0f : -1.0f, h);
}
"""
LOWP_BF16R_LOOP = """\
    const Ray rl = {bf16r(r.ox), bf16r(r.oy), bf16r(r.oz),
                    bf16r(r.dx), bf16r(r.dy), bf16r(r.dz)};
    for (int si = 0; si < n_sph; ++si)
      sphere_step_lowp(sph, n_sph, si, rl, h);"""
LOWP_SCALAR_STAGE = """\
#define BF_OP(name, op)                                              \\
  __device__ __forceinline__ unsigned short name(unsigned short a,   \\
                                                 unsigned short b) { \\
    unsigned short d;                                                \\
    asm(op " %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));               \\
    return d;                                                        \\
  }
BF_OP(bf_add, "add.rn.bf16")
BF_OP(bf_sub, "sub.rn.bf16")
BF_OP(bf_mul, "mul.rn.bf16")
__device__ __forceinline__ float bf_f(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}
__device__ __forceinline__ void sphere_one_lowp(const uint4 *__restrict__ spl,
                                                const float *__restrict__ sph,
                                                int ns, int si,
                                                const unsigned o2[3],
                                                const unsigned d2[3],
                                                Hit &h) {
  const uint4 c = spl[si >> 1];
  const int sh = (si & 1) * 16;
  const unsigned short cx = c.x >> sh, cy = c.y >> sh, cz = c.z >> sh,
                       r2 = c.w >> sh;
  const unsigned short ox = o2[0], oy = o2[1], oz = o2[2];
  const unsigned short dx = d2[0], dy = d2[1], dz = d2[2];
  const unsigned short ocx = bf_sub(ox, cx), ocy = bf_sub(oy, cy),
                       ocz = bf_sub(oz, cz);
  const unsigned short hb =
      bf_add(bf_add(bf_mul(ocx, dx), bf_mul(ocy, dy)), bf_mul(ocz, dz));
  const unsigned short cc = bf_sub(
      bf_add(bf_add(bf_mul(ocx, ocx), bf_mul(ocy, ocy)), bf_mul(ocz, ocz)),
      r2);
  sphere_root_lowp(sph, ns, si, bf_f(hb), bf_f(cc), bf_f(r2), h);
}
"""
LOWP_SCALAR_LOOP = """\
    for (int si = 0; si < n_sph; ++si)
      sphere_one_lowp(spl, sph, n_sph, si, o2, d2, h);"""
# K3 without its dead-warp skip and K1-lowp as conversions in one
# build (each measurement runs one kernel), K1-lowp as scalar bfloat16 in
# another
K3_LOWP_STUDIES = {
    "k3_no_skip_lowp_bf16r": {
        "wavefront_binned.cu": (K3_NO_SKIP,),
        "path_common.cuh": ((LOWP_ANCHOR, LOWP_BF16R_STAGE + LOWP_ANCHOR),
                            (LOWP_PAIRS, LOWP_BF16R_LOOP))},
    "lowp_scalar": {
        "path_common.cuh": ((LOWP_ANCHOR, LOWP_SCALAR_STAGE + LOWP_ANCHOR),
                            (LOWP_PAIRS, LOWP_SCALAR_LOOP))}}


# the residual study: K5s with a minimum of N resident blocks an SM
# (__launch_bounds__(THREADS, N)), which caps its registers at 65536 /
# (128 N) and keeps more warps resident, against the shipped kernel, whose
# residuals (22 floats a bounce) stay in local memory either way
RESIDUAL_BLOCKS = (4, 6)


def _residual_lib(n):
    return _study_lib(f"residual_study_{n}", {"wavefront_bwd.cu": ((
        "__global__ void __launch_bounds__(THREADS)\n"
        "    two_level_grad_kernel(",
        f"__global__ void __launch_bounds__(THREADS, {n})\n"
        "    two_level_grad_kernel("),)})


def measure_parts_k2(rtt, libs) -> dict:
    """What each part of the K2 and K5s designs buys at the 164k gradient
    pass: the pass's own K2 and K5s calls replayed with and without the
    staged tiles and with and without sub-leaf boxes (each sub-leaf given
    its leaf's box), and K5s with RESIDUAL_BLOCKS; the image, slab (zeros
    as +0) and camera lanes bitwise alike across the variants.  The
    (pixel, sample) layout's share is the variant with neither part against
    the parent's kernels, timed by ``--times`` in the same call."""
    from raytracer_tpu_torch.ops.cuda import build
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    dev = torch.device("cuda")
    scene, cam = (x.to(dev) for x in big_mesh_scene(rtt))
    loss_fn, start, shape, _ = _mesh_grad_setup(rtt, scene, cam, "164k")
    _, _, (fa, fk, _), (ba, bk, _) = _pass_kernels(loss_fn, start)
    real_load = build.load
    out, hashes = {}, set()
    variants = [(tiles, lib, subs) for tiles, lib in libs[:2]
                for subs in (True, False)] + [
        (tiles, lib, True) for tiles, lib in libs[2:]]
    log(f"\nK2 and K5s parts at the 164k pass {shape}")
    try:
        for tiles, lib, subs in variants:
            build.load = lambda csrc=None, lib=lib: lib
            fkv = dict(fk, sub_bounds=fk["sub_bounds"] if subs else None)
            bkv = dict(bk, sub_bounds=bk["sub_bounds"] if subs else None)
            f_ms = _event_ms(lambda: wfc.render_linear_cuda(*fa, **fkv))
            b_ms = _event_ms(lambda: wb.grad_slab_cuda(*ba, **bkv))
            img, _ = wfc.render_linear_cuda(*fa, **fkv)
            slab, cam_l = wb.grad_slab_cuda(*ba, **bkv)
            hashes.add((_sha(img), _sha(slab + 0.0), _sha(cam_l)))
            del img, slab, cam_l
            key = f"{tiles}, sub-leaf boxes {'on' if subs else 'off'}"
            out[key] = dict(k2_ms=f_ms, k5s_ms=b_ms)
            log(f"  {key}: K2 {f_ms:.3f} ms, K5s {b_ms:.3f} ms")
    finally:
        build.load = real_load
    log(f"  image, slab and camera lanes bitwise alike across the variants: "
        f"{len(hashes) == 1}")
    if len(hashes) != 1:
        raise SystemExit("the K2 / K5s design-part variants differ")
    return out


def measure_parts_k1(rtt, libs) -> dict:
    """What the (pixel, sample) layout and the staged chunks buy K1 and K5
    on the main path's calls (``k1_k5_calls``, replayed): as shipped,
    without staging (UNSTAGED_PATCHES: the one-level walk reads the table),
    with one thread a pixel (thread_layout's runs capped at one sample: the
    parent's 8x4-pixel warps, each thread looping its samples, on
    persistent warps), and with neither; every output bitwise alike across
    the variants (the slabs with their zeros as +0)."""
    from raytracer_tpu_torch.ops.cuda import build
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    calls = k1_k5_calls(rtt)
    real_load, real_run = build.load, ws.MAX_RUN
    out, digests = {}, set()
    log("\nK1 and K5 parts at the main path's calls")
    try:
        for (tiles, lib), run in [(x, r) for x in libs[:2]
                                  for r in (real_run, 1)]:
            build.load = lambda csrc=None, lib=lib: lib
            ws.MAX_RUN = run
            t = time_k1_k5(calls, runs=5)
            key = (f"{tiles}, " + ("(pixel, sample) runs" if run > 1
                                   else "one thread a pixel"))
            out[key] = {n: v["ms"] for n, v in t.items()}
            digests.add(json.dumps(
                {n: [{f: x for f, x in d.items() if f != "slab_raw"}
                     for d in v["digest"]] for n, v in t.items()},
                sort_keys=True))
            log(f"  {key}: " + "; ".join(
                f"{n} {' + '.join(f'{x:.3f}' for x in v['ms'])} ms"
                if n != "CLI bands" else
                f"{n} {sum(v['ms']):.3f} ms" for n, v in t.items()))
    finally:
        build.load, ws.MAX_RUN = real_load, real_run
    log(f"  images, segments, slabs and camera lanes bitwise alike across "
        f"the variants: {len(digests) == 1}")
    if len(digests) != 1:
        raise SystemExit("the K1 / K5 design-part variants differ")
    return out


def _k3_frames(rtt):
    """K3's main-path frames: phase 5c's three meshes at 512x512, 4 spp,
    depth 4, and the API session's OBJ-10k frame (512x288)."""
    scenes = mesh_scenes(rtt)
    frames = [(label, scene, cam, MESH_FULL)
              for label, (scene, cam) in scenes.items()]
    frames.append(("OBJ-10k session", *scenes["OBJ-10k"], API_SHAPE))
    return frames


def measure_parts_k3(rtt, libs) -> dict:
    """What each part of K3's design buys on its main path's frames (each
    frame capped as its probe set it, at seed 1; each pass replayed by CUDA
    events): the variants of ``libs`` (as shipped first and last, for the
    noise; unstaged; without the dead-warp skip); every frame bitwise alike
    across the variants."""
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import build
    dev = torch.device("cuda")
    calls = []
    for label, scene, cam, shape in _k3_frames(rtt):
        ops.render_linear_fast(scene, cam, device=dev, seed=1, **shape)
        args, kw = _binned_args(ops, tables, scene, cam, dev)
        calls.append((label, args, dict(shape, seed=1, **kw),
                      _caps(ops, scene, shape["width"], shape["height"])))
    real_load = build.load
    out, hashes = {}, {}
    log("\nK3 parts at its main path's frames")
    try:
        for name, lib in libs:
            build.load = lambda csrc=None, lib=lib: lib
            for label, args, kw, caps in calls:
                pass_ms, regroup_ms, res, _ = _k3_frame_timed(
                    args, kw, bounce_caps=caps)
                hashes.setdefault(label, set()).add((_sha(res[0]), res[1],
                                                     res[2]))
                out[f"{name}: {label}"] = dict(pass_ms=pass_ms,
                                               regroup_ms=regroup_ms)
                log(f"  K3 {name}, {label}: passes "
                    f"{[round(x, 3) for x in pass_ms]} = "
                    f"{sum(pass_ms):.3f} ms")
    finally:
        build.load = real_load
    same = all(len(h) == 1 for h in hashes.values())
    log(f"  frames bitwise alike across the variants: {same}")
    if not same:
        raise SystemExit("the K3 design-part variants' frames differ")
    return out


def measure_parts_lowp(rtt, libs) -> dict:
    """What K1-lowp's packed stage buys at the lowp study's frame (default
    world 512x512, 64 spp, depth 8, parity sign): the variants of ``libs``
    (packed first and last; per-operation conversions; scalar
    native bfloat16), with K1's float32 time beside them; every frame
    bitwise alike."""
    from raytracer_tpu_torch.ops.cuda import build
    from raytracer_tpu_torch.ops.cuda import wavefront as wfc
    dev = torch.device("cuda")
    args, _ = _lowp_args(rtt.models.default_world(), dev)
    kw = dict(LOWP_FULL, seed=1, parity_plane_sign=True)
    out = {"K1 float32": _event_ms(lambda: wfc.render_linear_cuda(*args,
                                                                  **kw))}
    real_load, hashes = build.load, set()
    log(f"\nK1-lowp parts at the lowp study's frame {LOWP_FULL}; K1 "
        f"float32 {out['K1 float32']:.3f} ms")
    try:
        for name, lib in libs:
            build.load = lambda csrc=None, lib=lib: lib
            out[name] = _event_ms(lambda: wfc.render_linear_cuda(
                *args, **kw, lowp=True))
            img, segs = wfc.render_linear_cuda(*args, **kw, lowp=True)
            hashes.add((_sha(img), segs))
            log(f"  K1-lowp {name}: {out[name]:.3f} ms")
    finally:
        build.load = real_load
    log(f"  frames bitwise alike across the variants: {len(hashes) == 1}")
    if len(hashes) != 1:
        raise SystemExit("the K1-lowp design-part variants differ")
    return out


def measure_parts(rtt, smi, staged, unstaged) -> dict:
    """What each part of the K4 and K6 designs buys, on this checkout: K4
    at the CLI's obj= frame (one launch, 16 bands) and at OBJ-10k 512x288
    with and without the staged tiles and with and without sub-leaf
    bounds; K6 at (A) and (B) with and without the staged tiles and with
    the live prefix or every slot each bounce (the test-only full-slot
    loop).  The frames stay bitwise alike across the variants."""
    from raytracer_tpu_torch import ops
    from raytracer_tpu_torch.ops import tables
    from raytracer_tpu_torch.ops.cuda import build
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    dev = torch.device("cuda")
    real_load = build.load
    scenes = mesh_scenes(rtt)
    cli_scene, cli_cam = _cli_frame(rtt, scenes["OBJ-10k"][0])
    cli = dict(width=512, height=287, samples_per_pixel=16, depth=8,
               seed=rtt.rng.DEFAULT_SEED)
    _, cargs, ckw = ops._stream_call(cli_scene, cli_cam, dev, plain=False)
    scene, cam = scenes["OBJ-10k"]
    _, aargs, akw = ops._stream_call(scene, cam, dev, plain=False)
    out, hashes = {"gpu": smi, "k4": {}, "k6": {}}, set()
    try:
        for tiles, lib in (("staged", staged), ("unstaged", unstaged)):
            build.load = lambda csrc=None, lib=lib: lib
            for subs in (True, False):
                ckw_v = dict(ckw, sub_bounds=ckw["sub_bounds"] if subs
                             else None)
                akw_v = dict(akw, sub_bounds=akw["sub_bounds"] if subs
                             else None)
                one = _event_ms(lambda: ws.render_linear_stream_cuda(
                    *cargs, **cli, **ckw_v))
                bands = _event_ms(lambda: [ws.render_linear_stream_cuda(
                    *cargs, **cli, **ckw_v, shard_rows=18, row_offset=r0)
                    for r0 in range(0, 287, 18)])
                api = _event_ms(lambda: ws.render_linear_stream_cuda(
                    *aargs, **API_SHAPE, seed=1, **akw_v))
                img, _ = ws.render_linear_stream_cuda(*cargs, **cli, **ckw_v)
                hashes.add(("k4", hashlib.sha256(
                    img.cpu().numpy().tobytes()).hexdigest()))
                key = f"{tiles}, sub-leaf bounds {'on' if subs else 'off'}"
                out["k4"][key] = dict(cli_one_ms=one, cli_bands_ms=bands,
                                      api_ms=api)
                log(f"  K4 {key}: CLI frame one launch {one:.3f} ms, 16 "
                    f"bands {bands:.3f} ms; 512x288 {api:.3f} ms")
            for label, key, fshape in (("A", "OBJ-10k", SORTED_A),
                                       ("B", "164k", SORTED_B)):
                sc, cm = scenes[key]
                args, kw = _binned_args(ops, tables, sc, cm, dev)
                for full_n in (False, True):
                    real = wso.render_linear_sorted

                    def render(*a, full_n=full_n, real=real, **k):
                        return wso._render_sorted(
                            *a[:14], a[-1], full_n=full_n, **{
                                "sph_clusters": None, "top_order": None,
                                "top_keys": None, "node_exit": True,
                                "plain": False, **k})
                    wso.render_linear_sorted = render
                    try:
                        b_ms, g_ms, _, res, _, _ = _k6_frame_timed(
                            args, dict(fshape, seed=1, **kw), runs=3)
                        sec, _ = _median_seconds(lambda seed: render(
                            *args, **fshape, seed=seed, **kw), runs=3)
                    finally:
                        wso.render_linear_sorted = real
                    hashes.add((label, hashlib.sha256(
                        res[0].cpu().numpy().tobytes()).hexdigest(), res[1]))
                    del res
                    vkey = (f"{tiles}, "
                            f"{'every slot' if full_n else 'live prefix'}")
                    out["k6"][f"{label}: {vkey}"] = dict(
                        bounce_ms=b_ms, regroup_ms=g_ms, frame_ms=sec * 1e3)
                    log(f"  K6 ({label}) {vkey}: bounces "
                        f"{[round(x, 3) for x in b_ms]} = {sum(b_ms):.3f} "
                        f"ms, sorts + gathers {[round(x, 3) for x in g_ms]}"
                        f" ms, frame {sec * 1e3:.3f} ms")
    finally:
        build.load = real_load
    log(f"  frames bitwise alike across the variants: "
        f"{len(hashes) == 3} ({len(hashes)} distinct of K4, (A), (B))")
    if len(hashes) != 3:
        raise SystemExit("the design-part variants' frames differ")
    return out


PARTS = ("k4k6", "k2", "k1", "k3", "lowp")


def parts_main(path, names=PARTS) -> int:
    """``--parts OUT [PART ...]``: of measure_parts ("k4k6"),
    measure_parts_k2 ("k2"), measure_parts_k1 ("k1"), measure_parts_k3
    ("k3") and measure_parts_lowp ("lowp") those named (all by default) on
    this checkout, as JSON in OUT."""
    from raytracer_tpu_torch.ops.cuda import build
    if not names or set(names) - set(PARTS):
        raise SystemExit(f"--parts takes parts of {PARTS}, got {names}")
    smi = phase_device()
    rtt = import_port()
    phase_build()
    libs = [("staged", build.load()), ("unstaged", _unstaged_lib())]
    out = {"gpu": smi}
    if "k2" in names:
        for n in RESIDUAL_BLOCKS:
            lib = _residual_lib(n)
            log(f"  K5s at {n} blocks an SM:")
            ptxas_report(Path(lib._name).parent / "ptxas.log")
            libs.append((f"staged, K5s at {n} blocks an SM", lib))
    studies = {}
    if {"k3", "lowp"} & set(names):
        for name, patches in K3_LOWP_STUDIES.items():
            studies[name] = _study_lib(name, patches)
            log(f"  {name}:")
            ptxas_report(Path(studies[name]._name).parent / "ptxas.log")
    if "k4k6" in names:
        out.update(measure_parts(rtt, smi, libs[0][1], libs[1][1]))
    if "k2" in names:
        out["k2"] = measure_parts_k2(rtt, libs)
    if "k1" in names:
        out["k1"] = measure_parts_k1(rtt, libs)
    if "k3" in names:
        out["k3"] = measure_parts_k3(rtt, [
            ("shipped", libs[0][1]), ("unstaged", libs[1][1]),
            ("no dead-warp skip", studies["k3_no_skip_lowp_bf16r"]),
            ("shipped again", libs[0][1])])
    if "lowp" in names:
        out["lowp"] = measure_parts_lowp(rtt, [
            ("packed bf16x2", libs[0][1]),
            ("bf16r conversions",
             studies["k3_no_skip_lowp_bf16r"]),
            ("scalar bf16", studies["lowp_scalar"]),
            ("packed bf16x2 again", libs[0][1])])
    Path(path).write_text(json.dumps(out))
    return 0


def times_main(tree, path) -> int:
    """``--times TREE OUT``: measure_k4_k6, measure_grad_times and
    measure_k3 for the port in the checkout TREE, its ptxas figures, as
    JSON in OUT."""
    smi = phase_device()
    rtt = import_port(tree)
    from raytracer_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    lib = build.load()
    log(f"times of {Path(rtt.__file__).parent}: built in "
        f"{time.perf_counter() - t0:.2f}s")
    ptxas = ptxas_report(Path(lib._name).parent / "ptxas.log",
                         required=False)
    out = measure_k4_k6(rtt, smi)
    out.update(measure_grad_times(rtt), k3=measure_k3(rtt), tree=str(tree),
               ptxas=ptxas)
    Path(path).write_text(json.dumps(out))
    return 0


def compare_times_main(paths) -> int:
    """``--compare-times OLD NEW ...``: the runs' times side by side; fails
    unless every run's (A), (B), CLI obj= and CLI framebuffers, K1's
    images and segments at the headline, the CLI's 16 bands and the two
    passes, K1-lowp's at its study frame, K5's slabs (zeros as +0) and
    camera lanes there, the 164k pass's image, segments, slab and camera
    lanes, and K3's frames (images and segments) hash alike."""
    runs = [json.loads(Path(p).read_text()) for p in paths]
    for p, r in zip(paths, runs):
        k4 = r["k4"]
        log(f"{p} ({r['tree']}, {r['gpu']}): K4 CLI frame one launch "
            f"{k4['cli_one_ms']:.3f} ms, 16 bands {k4['cli_bands_ms']:.3f} "
            f"ms; CLI shape, OBJ-10k's camera {k4['own_one_ms']:.3f} / "
            f"{k4['own_bands_ms']:.3f} ms; 512x288 {k4['api_ms']:.3f} ms; "
            f"ptxas {r['ptxas']}")
        for f in ("A", "B"):
            x = r[f]
            log(f"  ({f}) frame {x['frame_ms']:.3f} ms, "
                f"{x['rays_per_s']:.6e} rays/s; bounces "
                f"{[round(v, 3) for v in x['bounce_ms']]} = "
                f"{sum(x['bounce_ms']):.3f} ms; sorts + gathers "
                f"{[round(v, 3) for v in x['regroup_ms']]}; assembly "
                f"{x['assembly_ms']:.3f} ms; (slots, live) {x['slots']}; "
                f"peak {x['peak'] / 2**30:.3f} GiB")
    for p, r in zip(paths, runs):
        k, t = r["164k"], r["k1k5"]
        log(f"{p}: K1 headline {t['headline']['ms'][0]:.3f} ms, K1-lowp "
            f"{t['lowp study']['ms'][0]:.3f} ms, CLI 16 bands "
            f"{sum(t['CLI bands']['ms']):.3f} ms; default-world pass K1 "
            f"{t['default-world pass']['ms'][0]:.3f} ms, K5 "
            f"{t['default-world pass']['ms'][1]:.3f} ms; OBJ-10k pass "
            f"{r['obj10k']['pass_ms']:.3f} ms "
            f"({r['obj10k']['paths_per_s']:.6e} paths/s), K1 "
            f"{t['OBJ-10k pass']['ms'][0]:.3f} ms, K5 "
            f"{t['OBJ-10k pass']['ms'][1]:.3f} ms; 164k pass "
            f"{k['pass_ms']:.3f} ms ({k['paths_per_s']:.6e} paths/s), K2 "
            f"{k['k2_ms']:.3f} ms, K5s {k['k5s_ms']:.3f} ms")
    for p, r in zip(paths, runs):
        log(f"{p}: K3 " + "; ".join(
            f"{label} frame {x['frame_ms']:.3f} ms ({x['rays_per_s']:.6e} "
            f"rays/s), passes {sum(x['pass_ms']):.3f} ms "
            f"{[round(v, 3) for v in x['pass_ms']]}, regroups "
            f"{sum(x['regroup_ms']):.3f} ms" for label, x in r["k3"].items()))
    for key in ("164k", "default-world pass", "OBJ-10k pass"):
        raw = {json.dumps(r["164k"]["slab_raw_hash"] if key == "164k" else
                          r["k1k5"][key]["digest"][1]["slab_raw"])
               for r in runs}
        log(f"  {key} slab raw bytes: "
            f"{'equal in every run' if len(raw) == 1 else f'{len(raw)} hashes'}")
    same = [(("A", "hash"), lambda r: r["A"]["hash"]),
            (("A", "segs"), lambda r: r["A"]["segs"]),
            (("B", "hash"), lambda r: r["B"]["hash"]),
            (("B", "segs"), lambda r: r["B"]["segs"]),
            (("k4", "cli_hash"), lambda r: r["k4"]["cli_hash"]),
            (("k4", "cli_segs"), lambda r: r["k4"]["cli_segs"]),
            (("CLI", "framebuffer"), lambda r: r["fb"])]
    for name in K1_K5_SHAPES:
        same.append(((name, "K1 image, segments"),
                     lambda r, n=name: json.dumps(
                         r["k1k5"][n]["digest"][0], sort_keys=True)))
    for name in ("default-world pass", "OBJ-10k pass"):
        same.append(((name, "K5 slab (zeros as +0), camera lanes"),
                     lambda r, n=name: json.dumps(
                         {k: v for k, v in r["k1k5"][n]["digest"][1].items()
                          if k != "slab_raw"}, sort_keys=True)))
    for f in ("img_hash", "segs", "slab_hash", "cam_hash"):
        same.append((("164k", f), lambda r, f=f: r["164k"][f]))
    for label in runs[0]["k3"]:
        for f in ("hash", "segs", "frame_hash", "frame_segs"):
            same.append(((f"K3 {label}", f),
                         lambda r, n=label, f=f: r["k3"][n][f]))
    for key, get in same:
        vals = {get(r) for r in runs}
        log(f"  {key[0]} {key[1]}: "
            f"{'equal in every run' if len(vals) == 1 else vals}")
        if len(vals) != 1:
            raise SystemExit(f"old and new differ in {key}")
    return 0


# ---------------------------------------------------------------------------
# the reference-parity path (native engine, oracle, parity renderer,
# certification) and the viewers: phases 6a-6d
# ---------------------------------------------------------------------------

CLI_ARGS = ["samples=64", "ray_depth=8", "width=512"]
# tests/test_certify.py's tile and tests/test_native.py's FFI case
PARITY_TILES = (("default world", "default_world_source", 48, 27, 2, 8),
                ("FFI world", "ffi_example_source", 32, 18, 2, 4))
PARITY_CLI = ["parity=1", "width=64", "samples=1", "ray_depth=2"]
VIEWER = dict(width=400, samples=16, ray_depth=8, max_samples=48)


def phase_native_build() -> dict:
    """Build (or find) and load the native C++ library with the host
    compiler; its time and the compiler's version line are printed in 6a."""
    from raytracer_tpu_torch import native
    cxx = native.compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60,
                             check=True).stdout.splitlines()[0]
    built = not native.library_path().exists()
    t0 = time.perf_counter()
    lib = native.load_library()
    sec = time.perf_counter() - t0
    log(f"native: {lib._name} {'built' if built else 'found'} and loaded "
        f"in {sec:.3f}s ({cxx}: {version})")
    return dict(seconds=sec, built=built, path=lib._name, version=version)


def phase_native_writer(rtt, cli_fb, info) -> dict:
    """6a: the native PPM writer against the Python formatter on phase 4's
    framebuffer (bytes equal), both times, and cli.main's wall time with
    the native writer and with the formatter (the library made
    unavailable), in turns."""
    from raytracer_tpu_torch import cli, image, native
    log(f"\n6a native: library {'built' if info['built'] else 'found'} in "
        f"{info['seconds']:.3f}s by {info['version']}")
    with tempfile.TemporaryDirectory() as tmp:
        pn, pp = Path(tmp) / "n.ppm", Path(tmp) / "p.ppm"
        t0 = time.perf_counter()
        native.write_ppm_native(cli_fb, str(pn))
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pp.write_text(image.format_ppm(cli_fb))
        python_s = time.perf_counter() - t0
        if pn.read_bytes() != pp.read_bytes():
            raise SystemExit("6a: the native writer's bytes differ from the "
                             "Python formatter's")
        log(f"  {cli_fb.shape[1]}x{cli_fb.shape[0]} framebuffer: native "
            f"writer {native_s * 1e3:.3f} ms, Python formatter "
            f"{python_s * 1e3:.3f} ms, bytes equal ({pn.stat().st_size})")

        def unavailable(*a):
            raise native.NativeUnavailable("made unavailable for timing")

        walls = {"native": [], "formatter": []}
        real = native.write_ppm_native
        for writer in ("native", "formatter", "native", "formatter"):
            native.write_ppm_native = real if writer == "native" \
                else unavailable
            try:
                out = Path(tmp) / f"{writer}.ppm"
                t0 = time.perf_counter()
                if cli.main(CLI_ARGS + [f"out={out}"]) != 0:
                    raise SystemExit(f"6a: cli.main failed ({writer})")
                walls[writer].append(time.perf_counter() - t0)
            finally:
                native.write_ppm_native = real
        if (Path(tmp) / "native.ppm").read_bytes() != \
                (Path(tmp) / "formatter.ppm").read_bytes():
            raise SystemExit("6a: cli.main wrote other bytes with the "
                             "formatter")
    log(f"  cli.main({CLI_ARGS}) wall time: native writer "
        f"{[round(x, 4) for x in walls['native']]} s, Python formatter "
        f"{[round(x, 4) for x in walls['formatter']]} s")
    return dict(native_ms=native_s * 1e3, python_ms=python_s * 1e3,
                walls=walls)


def phase_parity(rtt, smi) -> dict:
    """6b: the sequential parity renderer on the card, bitwise the native
    engine and the oracle; the CLI's parity=1 bitwise ray_trace_parity."""
    import math
    from raytracer_tpu_torch import cli, image, native, oracle, render
    log(f"\n6b parity on the card ({smi})")
    rates = {}
    for label, source, w, h, spp, depth in PARITY_TILES:
        src = getattr(rtt.models, source)()
        world = rtt.parse_input(src)
        scene, cam = world.to_scene(), world.to_camera()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = render.ray_trace_parity(scene, cam, w, h, spp, depth,
                                      device="cuda")
        sec = time.perf_counter() - t0
        nat = native.NativeWorld(src).render(w, h, samples_per_pixel=spp,
                                             max_ray_bounces=depth)
        ocam, oworld = world.to_oracle()
        ref = oracle.ray_trace(oworld, ocam, w, h, spp, depth)
        same = (np.array_equal(got, nat), np.array_equal(got, ref))
        rate = w * h * spp / sec
        log(f"  {label} {w}x{h}, {spp} spp, depth {depth}: {sec:.3f} s, "
            f"{rate:.1f} samples/s ({rate * depth:.1f} bounce steps/s); "
            f"bitwise native {same[0]}, oracle {same[1]}")
        if not all(same):
            raise SystemExit(f"6b: {label}: the card's parity render "
                             f"differs (native {same[0]}, oracle {same[1]})")
        rates[label] = rate
    # what the graph buys: the same step run eagerly (one launch an
    # operation) against its graph replays, on a small tile, bitwise
    world = rtt.models.ffi_example_world()
    kw = dict(width=8, height=5, samples_per_pixel=2, depth=4)
    t0 = time.perf_counter()
    graphed = render.render_parity(world.to_scene(), world.to_camera(),
                                   device="cuda", **kw)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    with torch.inference_mode():
        step, (_, _, eager) = render._parity_step(
            world.to_scene().to("cuda"), world.to_camera().to("cuda"),
            kw["width"], kw["height"], kw["samples_per_pixel"], kw["depth"],
            rtt.rng.DEFAULT_SEED, True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(eager.shape[0]):
            step()
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
    steps = eager.shape[0] * kw["depth"]
    log(f"  the step eagerly against its graph (FFI world 8x5, 2 spp, depth "
        f"4): {steps / eager_s:.1f} against {steps / graph_s:.1f} bounce "
        f"steps/s (the graph's time includes its capture), bitwise "
        f"{torch.equal(eager.reshape(graphed.shape), graphed)}")
    if not torch.equal(eager.reshape(graphed.shape), graphed):
        raise SystemExit("6b: the graph replays differ from the eager step")
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "p.ppm"
        t0 = time.perf_counter()
        rc = cli.main(PARITY_CLI + ["device=cuda", f"out={out}"])
        sec = time.perf_counter() - t0
        fb = image.read_ppm(str(out))
    cam = rtt.Camera.new_look_at((0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                                 (0.0, 1.0, 0.0), math.pi / 2.0, 1.77778)
    want = render.ray_trace_parity(rtt.models.default_world().to_scene(),
                                   cam, 64, int(64 / 1.77778), 1, 2,
                                   device="cuda")
    log(f"  cli.main({PARITY_CLI}) rc={rc} in {sec:.3f} s: framebuffer "
        f"{fb.shape}, bitwise ray_trace_parity {np.array_equal(fb, want)}")
    if rc != 0 or not np.array_equal(fb, want):
        raise SystemExit("6b: the CLI's parity=1 frame differs")
    return rates


def phase_certify(smi) -> dict:
    """6c: certify at full size; one line of its report."""
    from raytracer_tpu_torch import certify
    log("\n6c certification")
    _zero_counts()
    report = certify.certify()
    counts = _read_counts()
    certify.DEFAULT_OUT.parent.mkdir(parents=True, exist_ok=True)
    certify.DEFAULT_OUT.write_text(json.dumps(report, indent=1) + "\n")
    keys = ("psnr_db", "mean_abs_diff_u8", "per_channel_max_diff_u8",
            "frac_pixels_diff_gt_8", "native_parity_sha256",
            "expected_native_parity_sha256", "fast_sha256",
            "native_seconds", "native_threads", "fast_seconds",
            "fast_segments", "fast_engine", "certified")
    log("  certify: " + json.dumps({k: report[k] for k in keys})
        + f"; launches {counts}; {smi}")
    # one K1 launch to warm up and one timed, and nothing else
    if report["fast_engine"] != "cuda" or counts != _only(K1=2):
        raise SystemExit(f"6c: the fast image came from "
                         f"{report['fast_engine']} with launches {counts}, "
                         f"not from K1 (two launches)")
    if not report["certified"]:
        raise SystemExit("6c: not certified (PSNR > 30 dB, mean |diff| < 4 "
                         "and the CERTIFY.json native sha256 are required)")
    return report


def _request(url, data=None):
    import urllib.request
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data else "GET")
    _zero_counts()
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        body, headers = r.read(), dict(r.headers)
    return body, headers, (time.perf_counter() - t0) * 1e3, _read_counts()


def _png_rgba(data: bytes) -> np.ndarray:
    """Decode ``image.png_bytes``' output (RGBA8, filter 0 on each row)."""
    import zlib
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = (int.from_bytes(body[4:8], "big"),
                    int.from_bytes(body[0:4], "big"))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 4 * w)
    return raw[:, 1:].reshape(h, w, 4)


def _served(session, script):
    """Serve ``session`` on 127.0.0.1 in a thread and send ``script``'s
    requests ((label, path, body)); each request's response, ms and launch
    counts."""
    import threading
    from raytracer_tpu_torch import httpviewer
    httpd = httpviewer.make_server(session, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        return [(label, *_request(base + path, body))
                for label, path, body in script]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


def phase_viewer(rtt) -> dict:
    """6d: the browser viewer on the card: a progressive default-world
    session as ``serve`` builds it (K1 once a rendered poll), then a mesh
    session over the 5120-triangle icosphere (K3, no K1)."""
    from raytracer_tpu_torch import viewer
    from raytracer_tpu_torch.api import RenderSession
    from raytracer_tpu_torch.models.builders import icosphere_mesh
    from raytracer_tpu_torch.scene import (DIFFUSE, METAL, build_materials,
                                           build_scene)
    log("\n6d viewer")
    w = VIEWER["width"]
    h = int(w / 1.77778)
    opts = rtt.Options(samples_per_pixel=VIEWER["samples"],
                       max_ray_bounces=VIEWER["ray_depth"])

    def session():
        return RenderSession(rtt.models.default_world_source(), w, h, opts,
                             device="cuda", progressive=True,
                             max_samples=VIEWER["max_samples"])
    move = json.dumps({"dx": 0.1, "dy": 0.0, "dz": 0.0}).encode()
    frame = ("/frame.png", "/frame.png", None)
    script = [("GET /", "/", None), frame, frame, frame,
              ("POST /move", "/move", move), frame,
              ("GET /camera", "/camera", None)]
    out = _served(session(), script)
    ms = {}
    polls = []
    for label, body, headers, t_ms, counts in out:
        ms.setdefault(label, []).append(t_ms)
        log(f"  {label}: {t_ms:.3f} ms, X-Samples "
            f"{headers.get('X-Samples', '-')}, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if label == "/frame.png":
            polls.append((headers["X-Samples"], counts, body))
    spp = [p[0] for p in polls]
    if spp != ["16", "32", "48", "16"]:
        raise SystemExit(f"6d: X-Samples {spp}, expected 16, 32, 48 and 16 "
                         f"after the move")
    for _, counts, _ in polls:
        if counts != _only(K1=1):
            raise SystemExit(f"6d: a rendered poll launched {counts}, "
                             f"expected one K1 launch and nothing else")
    first = _png_rgba(polls[0][2])
    fresh = session().frame()
    if not np.array_equal(first, fresh):
        raise SystemExit("6d: the first PNG is not a fresh session's frame")
    ansi = viewer.framebuffer_to_ansi(first)
    log(f"  first PNG bitwise a fresh session's frame(); "
        f"framebuffer_to_ansi: {len(ansi.splitlines())} rows, "
        f"{len(ansi)} chars")
    if len(ansi.splitlines()) != h // 2 or "▀" not in ansi:
        raise SystemExit("6d: bad ANSI blit")

    tris = icosphere_mesh((0.0, 0.0, -1.2), 0.5, 0, 4)       # 5120
    mats = build_materials([(DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                            (METAL, (0.8, 0.8, 0.8), 0.1, 1.0)])
    scene = build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                        exact_planes=True)
    mesh = RenderSession.from_world(
        scene, rtt.Camera.new_at((0.0, 0.0, 0.0), 1.77778), w, h, opts,
        device="cuda", progressive=True, max_samples=VIEWER["max_samples"])
    engine = mesh.resolved_engine()
    out = _served(mesh, [("/frame.png", "/frame.png", None)] * 2
                  + [("POST /move", "/move", move),
                     ("/frame.png", "/frame.png", None)])
    mesh_ms = []
    for label, body, headers, t_ms, counts in out:
        log(f"  mesh ({scene.num_triangles} triangles, {engine}) {label}: "
            f"{t_ms:.3f} ms, X-Samples {headers.get('X-Samples', '-')}, "
            f"launches { {k: v for k, v in counts.items() if v} }")
        if label == "/frame.png":
            mesh_ms.append(t_ms)
            if counts["K3"] < 1 or counts != _only(K3=counts["K3"]):
                raise SystemExit(f"6d: a mesh poll launched {counts}, "
                                 f"expected K3 and no other kernel")
    if engine != "cuda_binned":
        raise SystemExit(f"6d: the mesh session resolved to {engine}")
    return dict(ms=ms, mesh_ms=mesh_ms)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--times":
        return times_main(sys.argv[2], sys.argv[3])
    if len(sys.argv) > 1 and sys.argv[1] == "--compare-times":
        return compare_times_main(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == "--parts":
        return parts_main(sys.argv[2], tuple(sys.argv[3:]) or PARTS)
    smi = phase_device()
    rtt = import_port()
    phase_build()
    native_build = phase_native_build()
    scenes = mesh_scenes(rtt)
    max_err = phase_kernel_vs_plain(rtt)
    k5_err = phase_grad_vs_plain(rtt)
    mesh = phase_mesh_vs_plain(rtt, scenes)
    stream = phase_stream_vs_plain(rtt, scenes)
    sorted_small = phase_sorted_vs_plain(rtt, scenes)
    lowp_err = phase_lowp_vs_plain(rtt)
    launches, cli_k1_ms, cli_bound, cli_fb = phase_main_path(rtt)
    train = phase_train(rtt)
    phase_silhouette(rtt, smi)
    mesh_main = phase_mesh_main_paths(rtt, scenes)
    mgrad = phase_mesh_grad(rtt, scenes)
    smain = phase_sorted_main_paths(rtt, scenes)
    lowp_launches = phase_lowp_main_path(rtt)
    perf = phase_throughput(rtt, smi)
    gperf = phase_grad_throughput(rtt, smi)
    mperf = phase_mesh_throughput(rtt, smi, scenes, mesh_main["cli"])
    sperf = phase_mesh_grad_throughput(rtt, smi, scenes)
    soperf = phase_sorted_throughput(rtt, smi, scenes)
    phase_native_writer(rtt, cli_fb, native_build)
    phase_parity(rtt, smi)
    phase_certify(smi)
    phase_viewer(rtt)
    head = perf["default world 512x512 64spp depth 8"]
    big = sperf["164k"]
    # each kernel's device time over its launches on this run's main paths
    # (launches x the time at their shapes): the redesign order's input
    obj = sperf["OBJ-10k"]
    sums = {
        "K1": (cli_k1_ms + train["k1_launches"] * gperf["k1_ms"]
               + mgrad["launches"]["K1"] * obj["fwd_ms"],
               f"{launches} CLI bands {cli_k1_ms:.3f} ms (bound "
               f"{cli_bound[0]:.4f}), {train['k1_launches']} x "
               f"{gperf['k1_ms']:.3f} ms default-world passes, "
               f"{mgrad['launches']['K1']} x {obj['fwd_ms']:.3f} ms OBJ-10k "
               f"passes (bound {obj['k1_bound'][0]:.4f})"),
        "K5": (train["k5_launches"] * gperf["ms"]
               + mgrad["launches"]["K5"] * obj["bwd_ms"],
               f"{train['k5_launches']} x {gperf['ms']:.3f} + "
               f"{mgrad['launches']['K5']} x {obj['bwd_ms']:.3f} (bound "
               f"{obj['k5_bound'][0]:.4f})"),
        "K2": (mgrad["launches"]["K2"] * big["fwd_ms"],
               f"{mgrad['launches']['K2']} x the 164k pass's"),
        "K5s": (mgrad["launches"]["K5s"] * big["bwd_ms"],
                f"{mgrad['launches']['K5s']} x the 164k pass's"),
        "K1-lowp": (lowp_launches * soperf["lowp"]["ms"],
                    f"{lowp_launches} x the study frame's"),
        "K3": (mesh_main["k3_launches"] * mperf["k3"]["ms"]
               / API_SHAPE["depth"],
               f"{mesh_main['k3_launches']} passes at OBJ-10k 512x288's "
               f"mean"),
        "K4": (mesh_main["k4_launches"] * mperf["k4"]["ms"],
               f"{mesh_main['k4_launches']} CLI bands"),
        "K6": (sum(soperf["OBJ-10k"]["bounce_ms"])
               + sum(soperf["164k"]["bounce_ms"]),
               f"{smain['k6_launches']} bounces of (A) and (B)")}
    log("\nover this run's main-path launches: " + "; ".join(
        f"{k} {ms:.3f} ms ({how})" for k, (ms, how) in sums.items()))
    print(json.dumps({"kernels": [{
        "name": "wavefront_render (K1)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront.py:1032",
        "launches": launches + train["k1_launches"]
        + mgrad["launches"]["K1"],
        "max_abs_err": max(max_err, gperf["k1_err"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound"][0], "bound_by": head["bound"][1],
        "library_ms": None}, {
        "name": "wavefront_grad (K5)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront_bwd.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront_bwd.py:964",
        "launches": train["k5_launches"] + mgrad["launches"]["K5"],
        "max_abs_err": max(k5_err, gperf["k5_err"]),
        "ms": gperf["ms"], "plain_ms": gperf["plain_ms"],
        "bound_ms": gperf["bound"][0], "bound_by": gperf["bound"][1],
        "library_ms": None}, {
        "name": "binned_pass (K3)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront_binned.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront_binned.py:818",
        "launches": mesh_main["k3_launches"],
        "max_abs_err": max(mesh["worst"]["K3"], mperf["k3"]["err"],
                           mesh_main["k3_err"]),
        "ms": mperf["k3"]["ms"], "plain_ms": mperf["k3"]["plain_ms"],
        "bound_ms": mperf["k3"]["bound"][0],
        "bound_by": mperf["k3"]["bound"][1], "library_ms": None}, {
        "name": "stream_render (K4)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront_stream.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront_stream.py:397",
        "launches": mesh_main["k4_launches"],
        "max_abs_err": max(mesh["worst"]["K4"], mperf["k4_api"]["err"],
                           mesh_main["k4_err"]),
        "ms": mperf["k4"]["ms"], "plain_ms": mperf["k4"]["plain_ms"],
        "bound_ms": mperf["k4"]["bound"][0],
        "bound_by": mperf["k4"]["bound"][1], "library_ms": None}, {
        "name": "wavefront_render, two-level walk (K2)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront.py:1015",
        "launches": mgrad["launches"]["K2"],
        "max_abs_err": max(stream["err"]["K2"], big["k2_err"],
                           sperf["OBJ-10k"]["other_err"][0]),
        "ms": big["fwd_ms"], "plain_ms": big["k2_plain_ms"],
        "bound_ms": big["k2_bound"][0], "bound_by": big["k2_bound"][1],
        "library_ms": None}, {
        "name": "wavefront_grad, two-level walk (K5s)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront_bwd.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront_bwd.py:946",
        "launches": mgrad["launches"]["K5s"],
        "max_abs_err": max(stream["err"]["K5s"], big["k5s_err"],
                           sperf["OBJ-10k"]["other_err"][1]),
        "ms": big["bwd_ms"], "plain_ms": big["k5s_plain_ms"],
        "bound_ms": big["k5s_bound"][0], "bound_by": big["k5s_bound"][1],
        "library_ms": None}, {
        "name": "sorted_bounce (K6)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront_sorted.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront_sorted.py:689",
        "launches": smain["k6_launches"],
        "max_abs_err": max(sorted_small["worst"], soperf["k6"]["err"]),
        "ms": soperf["k6"]["ms"], "plain_ms": soperf["k6"]["plain_ms"],
        "bound_ms": soperf["k6"]["bound"][0],
        "bound_by": soperf["k6"]["bound"][1], "library_ms": None}, {
        "name": "wavefront_render, bf16 spheres (K1-lowp)", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/wavefront.cu",
        "replaces": "raytracer_tpu/ops/pallas/wavefront.py:374",
        "launches": lowp_launches,
        "max_abs_err": max(lowp_err, soperf["lowp"]["err"]),
        "ms": soperf["lowp"]["ms"], "plain_ms": soperf["lowp"]["plain_ms"],
        "bound_ms": soperf["lowp"]["bound"][0],
        "bound_by": soperf["lowp"]["bound"][1], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
