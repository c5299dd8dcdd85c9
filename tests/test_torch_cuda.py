"""K1 and K5 on the card: each CUDA kernel against its plain version (K1:
equal segment counts, max|diff| <= 1e-5; K5: winner ids equal, dsph, dtri
and dcam within 1e-5 * max|ref| + 1e-7), banding, the launch counters, a
render-then-grad round trip through both kernels and input checks.
Marked ``cuda``: each test skips where there is no GPU.  On a GPU machine
without JAX, run them without the suite's JAX conftest:
``python -m pytest tests/test_torch_cuda.py -q --noconftest``."""

import pytest
import torch

import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import ops
from raytracer_tpu_torch.ops import tables
from raytracer_tpu_torch.ops.cuda import wavefront as wfc

pytestmark = pytest.mark.cuda
TOL = 1e-5
KW = dict(width=48, height=27, samples_per_pixel=2, depth=8, seed=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(name, dev):
    if name in ("default_world", "ffi_example_world"):
        w = getattr(rtt.models, name)()
        scene, cam = w.to_scene(), w.to_camera()
    else:
        scene, cam = getattr(rtt.models, name)()
    parity = not scene.exact_planes
    sph, tri, scl, tcl = ops.scene_tables(scene, parity, dev)
    return (sph, tri, tables.camera_vec(cam).to(dev)), dict(
        parity_plane_sign=parity, sph_clusters=scl, tri_clusters=tcl)


@pytest.mark.parametrize("name", ["default_world", "ffi_example_world",
                                  "random_spheres", "mesh_scene"])
def test_kernel_matches_plain_version(dev, name):
    args, kw = _inputs(name, dev)
    before = wfc.LAUNCHES
    km, ks = wfc.render_linear_cuda(*args, **KW, **kw)
    torch.cuda.synchronize()
    assert wfc.LAUNCHES == before + 1
    pm, ps = wfc.render_linear_ref(*args, **KW, **kw)
    assert km.shape == (KW["height"], KW["width"], 3) and km.is_cuda
    assert torch.isfinite(km).all()
    assert ks == ps
    assert float((km - pm).abs().max()) <= TOL


def test_banded_kernel_bitwise_matches_rows(dev):
    args, kw = _inputs("ffi_example_world", dev)
    whole, wsegs = wfc.render_linear_cuda(*args, **KW, **kw)
    total = 0
    for r0 in range(0, KW["height"], 8):
        part, segs = wfc.render_linear_cuda(*args, **KW, **kw, shard_rows=8,
                                            row_offset=r0)
        rows = min(8, KW["height"] - r0)
        assert torch.equal(part[:rows], whole[r0:r0 + rows])
        total += segs
    assert total == wsegs


def test_render_linear_fast_uses_the_kernel(dev):
    w = rtt.models.default_world()
    before = wfc.LAUNCHES
    mean, segs = ops.render_linear_fast(
        w.to_scene(), w.to_camera(), width=32, height=32,
        samples_per_pixel=2, depth=4, device=dev, progress=lambda *a: None)
    assert wfc.LAUNCHES == before + 16 and mean.is_cuda and segs > 0


def test_kernel_rejects_bad_inputs(dev):
    (sph, tri, cv), kw = _inputs("default_world", dev)
    with pytest.raises(ValueError):
        wfc.render_linear_cuda(sph, tri, cv.cpu(), **KW, **kw)
    with pytest.raises(TypeError):
        wfc.render_linear_cuda(sph.double(), tri, cv, **KW, **kw)


# ---------------------------------------------------------------------------
# K5, the backward kernel
# ---------------------------------------------------------------------------

GKW = dict(width=40, height=24, samples_per_pixel=2, depth=4, seed=3)


def _grad_inputs(name, dev):
    from raytracer_tpu_torch.ops import diff
    if name == "mesh_scene":
        scene, cam = rtt.models.mesh_scene(2)
    else:
        w = getattr(rtt.models, name)()
        scene, cam = w.to_scene(), w.to_camera()
    scene, cam = scene.to(dev), cam.to(dev)
    parity = not scene.exact_planes
    cull = None if parity else diff.build_tri_cull(scene)
    tri_cl = None if cull is None else (
        diff.tri_cluster_bounds(scene, cull),
        torch.from_numpy(cull.ranges).to(dev))
    g = torch.randn(GKW["height"], GKW["width"], 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    return (diff.pack_spheres(scene).detach(),
            diff.pack_triangles(scene, perm=None if cull is None
                                else cull.perm).detach(),
            g, tables.camera_vec(cam)), dict(parity_plane_sign=parity,
                                             tri_clusters=tri_cl)


@pytest.mark.parametrize("name", ["default_world", "ffi_example_world",
                                  "mesh_scene"])
def test_k5_matches_plain_version(dev, name):
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    args, kw = _grad_inputs(name, dev)
    before = wb.LAUNCHES
    kslab, kcam = wb.grad_slab_cuda(*args, **GKW, **kw)
    torch.cuda.synchronize()
    assert wb.LAUNCHES == before + 1
    pslab, pcam = wb.grad_slab_ref(*args, **GKW, **kw)
    assert torch.equal(kslab[:, :, wb.GP_WIN], pslab[:, :, wb.GP_WIN])
    assert (pslab[:, :, wb.GP_WIN] >= 0).any()
    assert torch.isfinite(kslab).all() and torch.isfinite(kcam).all()
    S, T = args[0].shape[1], args[1].shape[1]
    for got, want in zip(wb.reduce_slab(kslab, kcam, S, T),
                         wb.reduce_slab(pslab, pcam, S, T)):
        assert float((got - want).abs().max()) <= \
            TOL * float(want.abs().max()) + 1e-7


def test_k5_banded_matches_plain_version(dev):
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    (sph, tri, g, cv), kw = _grad_inputs("default_world", dev)
    band = dict(shard_rows=8, row_offset=1, row_stride=3)
    g = g[:8].contiguous()
    got = wb.render_grad_cuda(sph, tri, g, cv, **GKW, **kw, **band)
    want = wb.render_grad_ref(sph, tri, g, cv, **GKW, **kw, **band)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= TOL * float(b.abs().max()) + 1e-7


def test_k5_rejects_bad_inputs(dev):
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    (sph, tri, g, cv), kw = _grad_inputs("default_world", dev)
    with pytest.raises(ValueError, match="MAX_DEPTH"):
        wb.render_grad_cuda(sph, tri, g, cv, **dict(GKW, depth=17), **kw)
    with pytest.raises(ValueError):
        wb.render_grad_cuda(sph, tri, g.cpu(), cv, **GKW, **kw)


def test_render_then_grad_round_trip_uses_both_kernels(dev):
    from raytracer_tpu_torch import grad
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    w = rtt.models.default_world()
    scene, cam = w.to_scene(dev), w.to_camera(dev)
    kw = dict(width=32, height=24, samples_per_pixel=2, depth=4, seed=1)
    target, _ = rtt.render_linear(scene, cam, **kw)
    params = grad.extract_params(scene, ["sphere_center", "mat_color"])
    params["sphere_center"] = params["sphere_center"] + 0.02
    for p in params.values():
        p.requires_grad_(True)
    k1, k5 = wfc.LAUNCHES, wb.LAUNCHES
    loss = grad.make_loss_fn(scene, cam, target, engine="auto", **kw)(params)
    loss.backward()
    torch.cuda.synchronize()
    assert (wfc.LAUNCHES - k1, wb.LAUNCHES - k5) == (1, 1)
    # against autograd through the wavefront renderer, at the JAX suite's
    # 5e-3 * max|ref| + 1e-7
    ref = {k: v.detach().clone().requires_grad_(True)
           for k, v in params.items()}
    grad.make_loss_fn(scene, cam, target, engine="xla", **kw)(ref).backward()
    for k in params:
        a, b = params[k].grad, ref[k].grad
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= \
            5e-3 * float(b.abs().max()) + 1e-7, k
