"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

``raytracer_tpu_torch/csrc/*.cu`` expose plain C functions (no PyTorch
headers) and share device code through ``csrc/*.cuh``.  Each ``.cu`` file
compiles to an object in its own ``nvcc`` process, all started together, and
one more ``nvcc`` links them into one shared library, cached under
``build/raytracer_tpu_torch/<hash>/`` at the repository root.  The hash
covers the sources, the headers and the flags, so an edit rebuilds and an
unchanged checkout reuses its build.  ``ptxas.log`` beside the library keeps
each kernel's register and local-memory use.  Nothing here runs at import
time: the first CUDA launch calls ``load()``.

Flags: ``-fmad=false`` keeps every multiply and add separately rounded (and
nvcc's defaults keep division and square root IEEE), so a kernel follows the
operation order of its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "raytracer_tpu_torch"
LIB_NAME = "libraytracer_tpu_torch.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or the default toolkit."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME to build the CUDA kernels")


def sources(csrc=CSRC_DIR) -> list[Path]:
    return sorted(Path(csrc).glob("*.cu"))


def source_hash(csrc=CSRC_DIR) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(Path(csrc).glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with the output of the first
    that fails, else return their stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}\n{err}")
    return [err for _, err in outs]


def build(csrc=CSRC_DIR) -> Path:
    """Compile the sources in ``csrc`` (the package's own unless a study
    build names another) unless this exact build exists; return the
    library's path.  Writes to a temporary directory and renames the
    library into place, so concurrent builds never load a half-written
    one."""
    out_dir = BUILD_ROOT / source_hash(csrc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources(csrc)]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(sources(csrc), objs)])
        tmp_lib = Path(tmp) / LIB_NAME
        _run_all([[nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)]])
        (out_dir / "ptxas.log").write_text("".join(logs))
        os.replace(tmp_lib, lib)
    return lib


@functools.cache
def load(csrc=CSRC_DIR) -> ctypes.CDLL:
    """Build if needed, load the library once per process and declare
    every entry point's C signature."""
    lib = ctypes.CDLL(str(build(csrc)))
    p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_float)
    fn = lib.rt_wavefront_render
    fn.argtypes = [p, i, p, p, i, p,     # sph, n_sph, packed sphere pairs,
                                         # tri, n_tri, cam
                   p, p, i, p, p, i, i,  # sphere / triangle clusters, chunks
                   p, p, p,              # mean, segs, counter
                   i, i, u, i, i, i,     # width .. shard_rows
                   i, i, f, i, i, i,     # spp .. parity, lowp, walk
                   i, i, i, i, i, i,     # thread layout: run .. blocks
                   p]                    # stream
    fn.restype = ctypes.c_int
    fn = lib.rt_wavefront_render_stream
    fn.argtypes = [p, i, p, p, i,        # sph, n_sph, sphere clusters
                   p, p, p, p, i,        # tri, leaf bounds / ranges, sub
                                         # bounds, n_leaves
                   p, p, i,              # top bounds / ranges, n_tops
                   p, p, p, p,           # cam, mean, segs, counter
                   i, i, u, i, i, i,     # width .. shard_rows
                   i, i, f,              # spp, depth, inv_spp
                   i, i, i, i, i, i,     # thread layout: run .. blocks
                   p]                    # stream
    fn.restype = ctypes.c_int
    fn = lib.rt_wavefront_grad
    fn.argtypes = [p, i, p, i, p,        # sph, n_sph, tri, n_tri, cam
                   p, p, i, i,           # triangle clusters, chunks
                   p, p, p, p,           # g_image, slab, cam_lanes, counter
                   i, i, u, i, i, i,     # width .. shard_rows
                   i, i, f, i, i,        # spp, depth, inv_spp, parity, walk
                   i, i, i, i, i, i,     # thread layout: run .. blocks
                   p]                    # stream
    fn.restype = ctypes.c_int
    fn = lib.rt_wavefront_grad_stream
    fn.argtypes = [p, i, p, p, p, p, i,  # sph, n_sph, tri, leaf bounds /
                                         # ranges, sub bounds, n_leaves
                   p, p, i, p,           # top bounds / ranges, n_tops, cam
                   p, p, p, p,           # g_image, slab, cam_lanes, counter
                   i, i, u, i, i, i,     # width .. shard_rows
                   i, i, f,              # spp, depth, inv_spp
                   i, i, i, i, i, i,     # thread layout: run .. blocks
                   p]                    # stream
    fn.restype = ctypes.c_int
    fn = lib.rt_stream_render
    fn.argtypes = [p, i, p, p, i,        # sph, n_sph, sphere clusters
                   p, p, p, p, i,        # tri, leaf bounds / counts, sub
                                         # bounds, n_leaves
                   p, p, p, p, i,        # top bounds / ranges / order / keys
                   p, p, p, p, p,        # root, cam, mean, segs, counter
                   i, i, u, i, i, i,     # width .. shard_rows
                   i, i, f,              # spp, depth, inv_spp
                   i, i, i, i, i, i,     # thread layout: run .. blocks
                   p]                    # stream
    fn.restype = ctypes.c_int
    fn = lib.rt_binned_pass
    fn.argtypes = [p, i, p, p, i,        # sph, n_sph, sphere clusters
                   p, p, i, p, i,        # tri, subn, n_subs, topr, n_tops
                   p, p, p,              # camera order, keys, run bounds
                   p, i, p, p, p,        # reference points, orders, keys, runs
                   p, p, p,              # root, key box
                   p, p, p, p, p, i,     # sub / grp / top / super AABBs
                   p, p, p, p, i,        # cam, state in / out, keys, n
                   i, i, u, i, i,        # width .. samp_off
                   i, i, i, i,           # spp, tw, th, ntx
                   i, i, i, i, p]        # primary .. use_super, stream
    fn.restype = ctypes.c_int
    fn = lib.rt_sorted_bounce
    fn.argtypes = [p, i, p, p, i,        # sph, n_sph, sphere clusters
                   p, p, p, i,           # tri, sub bounds / counts, n_subs
                   p, p, p, i,           # group / top bounds, top ranges, C
                   p, p, p,              # camera order, keys, run bounds
                   p, i, p, p, p,        # reference points, orders, keys, runs
                   p, p, p, p,           # root, key box, cam
                   p, p, p, i,           # state in / out, keys, n
                   i, i, i, i, u,        # width, height, spp, side, seed_word
                   i, i, i, p]           # bounce, primary, node_exit, stream
    fn.restype = ctypes.c_int
    return lib
