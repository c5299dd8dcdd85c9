"""K1, K2, K5, K5s, K4, K3, K6 and K1-lowp on the card: each CUDA kernel
against its plain version (K1, K2, K4, K3, K1-lowp: equal segment counts,
max|diff| <= 1e-5, K1-lowp's packed stage also bitwise; K6 and K3 on the
bench meshes: the same but for exact triangle ties on at most 0.01% of the
pixels; K5,
K5s: winner ids equal, dsph, dtri and dcam within 1e-5 * max|ref| + 1e-7),
K2 and K5s bitwise K1 and K5 over the same leaves, banding, the launch
counters, a render-then-grad round trip through K1 and K5 and one through
K2 and K5s, the mesh dispatch through K3, K4 and K6, and input checks.
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
    with torch.no_grad():
        t = diff.walk_tables(scene, None if parity
                             else diff.build_tri_cull(scene))
    g = torch.randn(GKW["height"], GKW["width"], 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    return (t["sph"], t["packed"], g, tables.camera_vec(cam)), dict(
        parity_plane_sign=parity, tri_clusters=t["clusters"])


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


# ---------------------------------------------------------------------------
# K2 and K5s, the two-level walk of the differentiable path
# ---------------------------------------------------------------------------

def _stream_inputs(name, dev):
    """Tables of both walks over one topology: mesh_scene(3) in leaves of
    16 (128 leaves, 8 tops), OBJ-10k in leaves of 128 (128 leaves of 80)."""
    from raytracer_tpu_torch.ops import diff
    scene, cam = (rtt.models.mesh_scene(3) if name == "mesh_scene3"
                  else rtt.models.obj_mesh_scene())
    scene, cam = scene.to(dev), cam.to(dev)
    cull = diff.build_tri_cull(scene, 16 if name == "mesh_scene3" else 128)
    with torch.no_grad():
        t = diff.walk_tables(scene, cull, two_level=True)
    g = torch.randn(GKW["height"], GKW["width"], 3, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    return dict(t, g=g, cam=tables.camera_vec(cam))


@pytest.mark.parametrize("name", ["mesh_scene3", "obj_mesh_scene"])
def test_k2_matches_plain_version_and_k1_over_the_same_leaves(dev, name):
    t = _stream_inputs(name, dev)
    kw = dict(GKW, parity_plane_sign=False, tri_clusters=t["clusters"])
    before = (wfc.LAUNCHES, wfc.STREAM_LAUNCHES)
    km, ks = wfc.render_linear_cuda(t["sph"], t["aligned"], t["cam"],
                                    tri_stream=t["tops"],
                                    sub_bounds=t["subs"], **kw)
    torch.cuda.synchronize()
    assert (wfc.LAUNCHES, wfc.STREAM_LAUNCHES) == (before[0], before[1] + 1)
    pm, ps = wfc.render_linear_ref(t["sph"], t["aligned"], t["cam"],
                                   tri_stream=t["tops"],
                                   sub_bounds=t["subs"], **kw)
    assert torch.isfinite(km).all() and ks == ps
    assert float((km - pm).abs().max()) <= TOL
    one, one_s = wfc.render_linear_cuda(t["sph"], t["packed"], t["cam"], **kw)
    assert torch.equal(km, one) and ks == one_s


@pytest.mark.parametrize("name", ["mesh_scene3", "obj_mesh_scene"])
def test_k5s_matches_plain_version_and_k5_over_the_same_leaves(dev, name):
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    t = _stream_inputs(name, dev)
    T = t["packed"].shape[1]
    kw = dict(GKW, parity_plane_sign=False, tri_clusters=t["clusters"])
    skw = dict(kw, tri_stream=t["tops"], sub_bounds=t["subs"],
               n_tris_packed=T)
    args = (t["sph"], t["aligned"], t["g"], t["cam"])
    before = (wb.LAUNCHES, wb.STREAM_LAUNCHES)
    kslab, kcam = wb.grad_slab_cuda(*args, **skw)
    torch.cuda.synchronize()
    assert (wb.LAUNCHES, wb.STREAM_LAUNCHES) == (before[0], before[1] + 1)
    pslab, pcam = wb.grad_slab_ref(*args, **skw)
    assert torch.equal(kslab[:, :, wb.GP_WIN], pslab[:, :, wb.GP_WIN])
    assert (pslab[:, :, wb.GP_WIN] >= t["sph"].shape[1]).any()
    S = t["sph"].shape[1]
    for got, want in zip(wb.reduce_slab(kslab, kcam, S, T),
                         wb.reduce_slab(pslab, pcam, S, T)):
        assert float((got - want).abs().max()) <= \
            TOL * float(want.abs().max()) + 1e-7
    oslab, ocam = wb.grad_slab_cuda(t["sph"], t["packed"], t["g"], t["cam"],
                                    **kw)
    assert torch.equal(kslab, oslab) and torch.equal(kcam, ocam)


@pytest.mark.parametrize("case", ["band, 3 spp", "no sub-leaf boxes, 8 spp"])
def test_k2_k5s_bitwise_k1_k5_on_a_band_and_without_sub_leaf_boxes(dev, case):
    """K2 and K5s in their (pixel, sample) layout on a strided band at a
    spp off the run (lanes past spp trace nothing), and with each sub-leaf
    given its leaf's box: bitwise K1 and K5 over the same leaves (image,
    segments, slab, camera lanes), and K5s's winners those of its plain
    version."""
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    t = _stream_inputs("obj_mesh_scene", dev)
    T = t["packed"].shape[1]
    if case.startswith("band"):
        shape = dict(GKW, samples_per_pixel=3, shard_rows=7, row_offset=2,
                     row_stride=3)
        subs = t["subs"]
    else:
        shape = dict(GKW, samples_per_pixel=8)
        subs = None
    rows = shape.get("shard_rows", shape["height"])
    g = t["g"][:rows].contiguous()
    kw = dict(shape, parity_plane_sign=False, tri_clusters=t["clusters"])
    skw = dict(kw, tri_stream=t["tops"], sub_bounds=subs)
    km, ks = wfc.render_linear_cuda(t["sph"], t["aligned"], t["cam"], **skw)
    one, one_s = wfc.render_linear_cuda(t["sph"], t["packed"], t["cam"], **kw)
    assert km.shape == (rows, shape["width"], 3)
    assert torch.equal(km, one) and ks == one_s and ks > 0
    kslab, kcam = wb.grad_slab_cuda(t["sph"], t["aligned"], g, t["cam"],
                                    n_tris_packed=T, **skw)
    oslab, ocam = wb.grad_slab_cuda(t["sph"], t["packed"], g, t["cam"], **kw)
    assert torch.equal(kslab, oslab) and torch.equal(kcam, ocam)
    pslab, _ = wb.grad_slab_ref(t["sph"], t["aligned"], g, t["cam"],
                                n_tris_packed=T, **skw)
    assert torch.equal(kslab[:, :, wb.GP_WIN], pslab[:, :, wb.GP_WIN])


def test_streamed_gradient_pass_launches_k2_and_k5s(dev, monkeypatch):
    """A scene forced past the table budget: one K2 and one K5s launch per
    value and gradient, no K1 or K5, and the one-level pass's gradients."""
    from raytracer_tpu_torch import grad
    from raytracer_tpu_torch.ops import diff
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    scene, cam = rtt.models.mesh_scene(3)
    scene, cam = scene.to(dev), cam.to(dev)
    kw = dict(width=32, height=24, samples_per_pixel=2, depth=3, seed=1,
              parity_plane_sign=False)
    target = torch.rand(24, 32, 3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    grads, counts = {}, {}
    for forced in (True, False):
        monkeypatch.setattr(diff, "_needs_stream", lambda s, f=forced: f)
        p = grad.extract_params(scene, ["tri_v0", "mat_color"])
        for v in p.values():
            v.requires_grad_(True)
        c0 = (wfc.LAUNCHES, wfc.STREAM_LAUNCHES, wb.LAUNCHES,
              wb.STREAM_LAUNCHES)
        grad.make_loss_fn(scene, cam, target, engine="auto", **kw)(
            p).backward()
        torch.cuda.synchronize()
        counts[forced] = tuple(b - a for a, b in zip(c0, (
            wfc.LAUNCHES, wfc.STREAM_LAUNCHES, wb.LAUNCHES,
            wb.STREAM_LAUNCHES)))
        grads[forced] = {k: v.grad for k, v in p.items()}
    assert counts == {True: (0, 1, 0, 1), False: (1, 0, 1, 0)}
    for k, a in grads[True].items():
        b = grads[False][k]
        assert torch.isfinite(a).all() and a.any()
        assert float((a - b).abs().max()) <= \
            TOL * float(b.abs().max()) + 1e-7, k


# ---------------------------------------------------------------------------
# K4 and K3, the mesh engines
# ---------------------------------------------------------------------------

MKW = dict(width=64, height=36, samples_per_pixel=2, depth=4, seed=5)


def _mesh(name):
    scene, cam = (rtt.models.obj_mesh_scene() if name == "obj_mesh_scene"
                  else rtt.models.mesh_scene(int(name[-1])))
    return scene, cam


@pytest.mark.parametrize("name", ["mesh_scene2", "mesh_scene3",
                                  "obj_mesh_scene"])
def test_k4_matches_plain_version(dev, name):
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    scene, cam = _mesh(name)
    fn, args, kw = ops._stream_call(scene, cam, dev, plain=False)
    before = ws.LAUNCHES
    km, ks = ws.render_linear_stream_cuda(*args, **MKW, **kw)
    torch.cuda.synchronize()
    assert ws.LAUNCHES == before + 1
    pm, ps = ws.render_linear_stream_ref(*args, **MKW, **kw)
    assert torch.isfinite(km).all() and ks == ps
    assert float((km - pm).abs().max()) <= TOL
    band, bs = ws.render_linear_stream_cuda(*args, **MKW, **kw,
                                            shard_rows=8, row_offset=9)
    assert torch.equal(band, km[9:17])


@pytest.mark.parametrize("spp", [1, 3, 17])
def test_k4_bitwise_plain_version_at_depth_8(dev, spp):
    """K4's (pixel, sample) threads and sample-order sum: bitwise the plain
    version at a spp below, off and above the 16-sample run."""
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    scene, cam = _mesh("obj_mesh_scene")
    _, args, kw = ops._stream_call(scene, cam, dev, plain=False)
    shape = dict(width=40, height=24, samples_per_pixel=spp, depth=8, seed=2)
    km, ks = ws.render_linear_stream_cuda(*args, **shape, **kw)
    pm, ps = ws.render_linear_stream_ref(*args, **shape, **kw)
    assert torch.equal(km, pm) and ks == ps


def test_k4_sixteen_bands_bitwise_the_whole_frame(dev):
    """16 row bands of a 64x37 frame (5 of 3 rows, 11 of 2), then the
    CLI's banding (13 bands of 3, a ragged last one): the bands' rows are
    bitwise one launch's, segments add up."""
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    scene, cam = _mesh("mesh_scene3")
    _, args, kw = ops._stream_call(scene, cam, dev, plain=False)
    shape = dict(width=64, height=37, samples_per_pixel=4, depth=4, seed=1)
    whole, segs = ws.render_linear_stream_cuda(*args, **shape, **kw)
    sixteen = [3] * 5 + [2] * 11
    cli = [3] * 13
    for sizes in (sixteen, cli):
        rows, total, r0 = [], 0, 0
        for n in sizes:
            part, s = ws.render_linear_stream_cuda(
                *args, **shape, **kw, shard_rows=n, row_offset=r0)
            rows.append(part[:min(n, 37 - r0)])
            total += s
            r0 += n
        assert torch.equal(torch.cat(rows), whole) and total == segs


def test_k6_live_prefix_bitwise_the_full_slot_frame(dev):
    """The live-prefix K6 frame against the bounce loop that launches
    and sorts every slot each bounce (the test-only ``full_n``)."""
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    scene, cam = _mesh("obj_mesh_scene")
    (sph, scl, *t) = ops.scene_sorted_tables(scene, dev)
    order, keys = ops._camera_order(t[4], cam, dev)
    args = (sph, *t[:13], tables.camera_vec(cam).to(dev))
    kw = dict(width=64, height=36, samples_per_pixel=8, depth=4, seed=3,
              sph_clusters=scl, top_order=order, top_keys=keys,
              node_exit=True, plain=False)
    ids = {True: [], False: []}
    frames = {full: wso._render_sorted(
        *args, **kw, full_n=full, slots=lambda i, f=full: ids[f].append(i))
        for full in (True, False)}
    assert torch.equal(frames[True][0], frames[False][0])
    assert frames[True][1] == frames[False][1]
    assert all(torch.equal(a, b) for a, b in zip(ids[True], ids[False]))
    assert len(ids[False]) == 3


@pytest.mark.parametrize("name", ["mesh_scene2", "mesh_scene3",
                                  "obj_mesh_scene"])
def test_k3_matches_plain_version(dev, name):
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    scene, cam = _mesh(name)
    (sph, scl, *t) = ops.scene_sorted_tables(scene, dev)
    order, keys = ops._camera_order(t[4], cam, dev)
    args = (sph, *t, tables.camera_vec(cam).to(dev))
    kw = dict(MKW, sph_clusters=scl, top_order=order, top_keys=keys)
    before = wb.LAUNCHES
    km, ks = wb.render_linear_binned(*args, **kw)
    torch.cuda.synchronize()
    assert wb.LAUNCHES == before + MKW["depth"]
    pm, ps = wb.render_linear_binned(*args, **kw, plain=True)
    assert torch.isfinite(km).all() and ks == ps
    assert float((km - pm).abs().max()) <= TOL
    for variant in (dict(super_selection=True), dict(node_exit=False),
                    dict(bounce_caps=(1 << 20,) * 3)):
        got = wb.render_linear_binned(*args, **kw, **variant)
        assert torch.equal(got[0], km) and got[1] == ks
    assert float(wb.render_linear_binned(*args, **kw,
                                         bounce_caps=(32,) * 3)[2]) > 0


def test_mesh_dispatch_launches_k3_unbanded_and_k4_banded(dev):
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    scene, cam = rtt.models.mesh_scene(3)
    counts = (wfc.LAUNCHES, wb.LAUNCHES, ws.LAUNCHES)
    shape = dict(width=48, height=32, samples_per_pixel=4, depth=3,
                 device=dev)
    ops.render_linear_fast(scene, cam, **shape)
    ops.render_linear_fast(scene, cam, **shape, progress=lambda *a: None)
    assert (wfc.LAUNCHES - counts[0], wb.LAUNCHES - counts[1],
            ws.LAUNCHES - counts[2]) == (0, 3, 16)
    assert ops.flush_binned_overflow_checks() == 0


def _image_within(km, pm, ks, ps):
    """3e's bar: equal segments, max|diff| <= TOL except exact triangle
    ties on at most 0.01% of the pixels."""
    d = (km - pm).abs().amax(dim=-1)
    return ks == ps and int((d > TOL).sum()) <= 1e-4 * d.numel()


@pytest.mark.parametrize("shape", [MKW, dict(MKW, width=37, height=21)])
def test_k6_matches_plain_version(dev, shape):
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    scene, cam = _mesh("mesh_scene3")
    (sph, scl, *t) = ops.scene_sorted_tables(scene, dev)
    order, keys = ops._camera_order(t[4], cam, dev)
    args = (sph, *t, tables.camera_vec(cam).to(dev))
    kw = dict(shape, sph_clusters=scl, top_order=order, top_keys=keys)
    before = wso.LAUNCHES
    km, ks = wso.render_linear_sorted(*args, **kw)
    torch.cuda.synchronize()
    assert wso.LAUNCHES == before + shape["depth"]
    pm, ps = wso.render_linear_sorted(*args, **kw, plain=True)
    assert torch.isfinite(km).all() and _image_within(km, pm, ks, ps)
    got = wso.render_linear_sorted(*args, **kw, node_exit=False)
    assert torch.equal(got[0], km) and got[1] == ks


def test_k6_dispatch_launches_k6_past_128_spp(dev):
    from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
    scene, cam = _mesh("obj_mesh_scene")
    shape = dict(width=32, height=18, samples_per_pixel=130, depth=2,
                 device=dev)
    before = (wso.LAUNCHES, wfc.LAUNCHES)
    ops.render_linear_fast(scene, cam, **shape)
    torch.cuda.synchronize()
    assert (wso.LAUNCHES - before[0], wfc.LAUNCHES - before[1]) == (2, 0)


@pytest.mark.parametrize("name", ["default_world", "unit_scene"])
def test_k1_lowp_matches_plain_version(dev, name):
    if name == "default_world":
        w = rtt.models.default_world()
    else:
        w = rtt.parse_input(
            "camera origin 0.0 0.0 0.0 aspect 1.0;\n"
            "material M : Metal color 0.9 0.8 0.7 fuzz 0.1;\n"
            "material D : Diffuse color 0.4 0.6 0.3;\n"
            "sphere center -0.6 0.0 -1.6 radius 0.5 material M;\n"
            "sphere center 0.6 0.1 -1.4 radius 0.45 material D;\n")
    scene, cam = w.to_scene(), w.to_camera()
    sph, tri, _, _ = ops.scene_tables(scene, True, dev)
    args = (sph, tri, tables.camera_vec(cam).to(dev))
    kw = dict(width=64, height=36, samples_per_pixel=4, depth=8, seed=3,
              lowp=True)
    before = (wfc.LAUNCHES, wfc.LOWP_LAUNCHES)
    km, ks = wfc.render_linear_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert (wfc.LAUNCHES, wfc.LOWP_LAUNCHES) == (before[0], before[1] + 1)
    pm, ps = wfc.render_linear_ref(*args, **kw)
    assert torch.isfinite(km).all() and ks == ps
    assert float((km - pm).abs().max()) <= TOL


# ---------------------------------------------------------------------------
# K1, K1-lowp and K5 in the (pixel, sample) layout: each triangle walk
# against its plain version and bitwise the parent's one thread a pixel
# (runs of one sample: 8x4 pixels a warp, each thread looping its samples)
# ---------------------------------------------------------------------------

WALK_CASES = {"default_world": "none", "ffi_example_world": "flat",
              "mesh_scene": "leaves"}
LKW = dict(width=40, height=23, samples_per_pixel=5, depth=6, seed=2,
           shard_rows=9, row_offset=3, row_stride=2)


def _walk_of(tri, tcl):
    walk, _ = wfc.tri_walk(tri, tcl)
    return {wfc.WALK_NONE: "none", wfc.WALK_FLAT: "flat",
            wfc.WALK_LEAVES: "leaves"}[walk]


def _one_thread_a_pixel(monkeypatch):
    from raytracer_tpu_torch.ops.cuda import wavefront_stream as ws
    monkeypatch.setattr(ws, "MAX_RUN", 1)
    assert ws.thread_layout(40, 9, 5)[:3] == (1, 8, 4)


@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_k1_walks_match_plain_and_one_thread_a_pixel(dev, name, lowp,
                                                     monkeypatch):
    args, kw = _inputs(name, dev)
    assert _walk_of(args[1], kw["tri_clusters"]) == WALK_CASES[name]
    kw = dict(kw, lowp=lowp, **LKW)
    km, ks = wfc.render_linear_cuda(*args, **kw)
    pm, ps = wfc.render_linear_ref(*args, **kw)
    assert torch.isfinite(km).all() and ks == ps
    assert float((km - pm).abs().max()) <= TOL
    _one_thread_a_pixel(monkeypatch)
    om, os_ = wfc.render_linear_cuda(*args, **kw)
    assert torch.equal(km, om) and ks == os_


@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_k5_walks_match_plain_and_one_thread_a_pixel(dev, name,
                                                     monkeypatch):
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    (sph, tri, g, cv), kw = _grad_inputs(name, dev)
    assert _walk_of(tri, kw["tri_clusters"]) == WALK_CASES[name]
    shape = dict(LKW, samples_per_pixel=3, depth=4)
    g = g[:shape["shard_rows"], :shape["width"]].contiguous()
    kslab, kcam = wb.grad_slab_cuda(sph, tri, g, cv, **shape, **kw)
    pslab, pcam = wb.grad_slab_ref(sph, tri, g, cv, **shape, **kw)
    assert torch.equal(kslab[:, :, wb.GP_WIN], pslab[:, :, wb.GP_WIN])
    assert (pslab[:, :, wb.GP_WIN] >= 0).any()
    S, T = sph.shape[1], tri.shape[1]
    for got, want in zip(wb.reduce_slab(kslab, kcam, S, T),
                         wb.reduce_slab(pslab, pcam, S, T)):
        assert float((got - want).abs().max()) <= \
            TOL * float(want.abs().max()) + 1e-7
    _one_thread_a_pixel(monkeypatch)
    oslab, ocam = wb.grad_slab_cuda(sph, tri, g, cv, **shape, **kw)
    # zeros as +0: a dead lane writes 0 x its stale hit, whose sign follows
    # its warp's walk
    assert torch.equal(kslab + 0.0, oslab + 0.0)
    assert torch.equal(kcam, ocam)


# ---------------------------------------------------------------------------
# K3's staged walk and dead-warp skip on the bench meshes, and K1-lowp's
# packed bfloat16 stage
# ---------------------------------------------------------------------------

def _bench_mesh(name):
    if name == "164k":
        from raytracer_tpu_torch.models.builders import icosphere_mesh
        from raytracer_tpu_torch.scene import (DIFFUSE, METAL,
                                               build_materials, build_scene)
        tris = (icosphere_mesh((-0.6, 0.0, -1.4), 0.45, 0, 6)
                + icosphere_mesh((0.6, 0.0, -1.2), 0.45, 2, 6))
        mats = build_materials([(DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                                (DIFFUSE, (0.8, 0.8, 0.0), 0.0, 1.0),
                                (METAL, (0.85, 0.85, 0.9), 0.05, 1.0)])
        scene = build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                            exact_planes=True)
        return scene, rtt.Camera.new_at((0.0, 0.0, 0.0), 1.77778)
    return _mesh("obj_mesh_scene" if name == "OBJ-10k" else "mesh_scene3")


@pytest.mark.parametrize("shape", [MKW, dict(MKW, width=37, height=21,
                                             samples_per_pixel=4)])
@pytest.mark.parametrize("name", ["mesh-1292", "OBJ-10k", "164k"])
def test_k3_staged_walk_on_the_bench_meshes(dev, name, shape):
    """K3 (staged sub-leaves, dead warps skipped: the 37x21 frame pads its
    tile with dead slots, generous caps keep dead warps in every pass)
    against its plain version with 3e's bar, and the supertop scan,
    node_exit and caps variants bitwise the default run."""
    from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
    scene, cam = _bench_mesh(name)
    (sph, scl, *t) = ops.scene_sorted_tables(scene, dev)
    order, keys = ops._camera_order(t[4], cam, dev)
    args = (sph, *t, tables.camera_vec(cam).to(dev))
    kw = dict(shape, sph_clusters=scl, top_order=order, top_keys=keys)
    km, ks = wb.render_linear_binned(*args, **kw)
    pm, ps = wb.render_linear_binned(*args, **kw, plain=True)
    assert torch.isfinite(km).all() and _image_within(km, pm, ks, ps)
    super_on = t[4].shape[1] >= wb.SUPER_MIN_TOPS
    for variant in (dict(super_selection=not super_on),
                    dict(node_exit=False),
                    dict(bounce_caps=(1 << 20,) * 3)):
        got = wb.render_linear_binned(*args, **kw, **variant)
        assert torch.equal(got[0], km) and got[1] == ks


@pytest.mark.parametrize("name", ["default_world", "three_spheres"])
def test_k1_lowp_packed_stage_bitwise_plain(dev, name):
    """K1-lowp's packed bfloat16 stage bitwise its plain version, with an
    even sphere count and an odd one (the packed table's padding sphere)."""
    if name == "default_world":
        w = rtt.models.default_world()
    else:
        w = rtt.parse_input(
            "camera origin 0.0 0.0 0.0 aspect 1.0;\n"
            "material M : Metal color 0.9 0.8 0.7 fuzz 0.1;\n"
            "material D : Diffuse color 0.4 0.6 0.3;\n"
            "material G : Dielectric ir 1.5;\n"
            "sphere center -0.6 0.0 -1.6 radius 0.5 material M;\n"
            "sphere center 0.6 0.1 -1.4 radius 0.45 material D;\n"
            "sphere center 0.0 -0.3 -1.1 radius 0.2 material G;\n")
    scene, cam = w.to_scene(), w.to_camera()
    sph, tri, _, _ = ops.scene_tables(scene, True, dev)
    assert sph.shape[1] % 2 == (name == "three_spheres")
    args = (sph, tri, tables.camera_vec(cam).to(dev))
    kw = dict(width=64, height=36, samples_per_pixel=4, depth=8, seed=3,
              lowp=True)
    before = wfc.LOWP_LAUNCHES
    km, ks = wfc.render_linear_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert wfc.LOWP_LAUNCHES == before + 1
    pm, ps = wfc.render_linear_ref(*args, **kw)
    assert torch.equal(km, pm) and ks == ps
    f32, _ = wfc.render_linear_cuda(*args, **dict(kw, lowp=False))
    assert not torch.equal(km, f32)
