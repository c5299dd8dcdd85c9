"""The port's differentiable kernel path (ops/diff.py, K5's plain version
ops/cuda/wavefront_bwd.py) against the JAX package's ops/diff.py and the
backward Pallas kernel in interpret mode, on the same inputs.

Bars: the sphere packer and the cull topology equal; the triangle packer
within 1e-6 * max|ref| (XLA:CPU fuses the cross products' a * b - c * d into
multiply-adds, the port rounds each operation); each packer's VJP within
1e-6 * max|ref|; render_grad_ref's dsph, dtri and dcam within
1e-4 * max|ref| + 1e-7 of render_grad_pallas(interpret=True), winner ids
equal lane for lane -- on the default world's spheres, see FMA_GAP."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.ops import diff as jdiff
from raytracer_tpu.ops.pallas import wavefront as jwf
from raytracer_tpu.ops.pallas import wavefront_bwd as jwb
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch.ops import diff as tdiff
from raytracer_tpu_torch.ops import tables
from raytracer_tpu_torch.ops.cuda import wavefront as twf
from raytracer_tpu_torch.ops.cuda import wavefront_bwd as twb

# On the default world's eight spheres (which the FFI world shares)
# render_grad_ref and the Pallas kernel in interpret mode differ by up to
# 1.1e-4 * max|ref| (measured at the cases below: dsph 9.8e-5, dcam 1.11e-4
# on both worlds) with every winner id equal.  Cause: XLA:CPU contracts
# a * b - c into one fused multiply-add (jit of a * a - c equals the fused
# result on 100000 of 100000 random float32 inputs); K5 and its plain version round every operation, and at
# lanes that graze the metal and glass spheres the implicit-t adjoint's
# 1 / (u . d) amplifies the difference.
FMA_GAP = 1e-3
SHARED_SPHERES = ("default_world", "ffi_example_world")


def _worlds(name):
    if name.startswith("mesh_scene"):
        sub = int(name[-1])
        return rtt.models.mesh_scene(sub), rt.models.mesh_scene(sub)
    tw, jw = getattr(rtt.models, name)(), getattr(rt.models, name)()
    return (tw.to_scene(), tw.to_camera()), (jw.to_scene(), jw.to_camera())


PACK_CASES = ["default_world", "ffi_example_world", "mesh_scene2"]


@pytest.mark.parametrize("name", PACK_CASES)
def test_packers_match_jax(name):
    (ts, _), (js, _) = _worlds(name)
    jcull = jdiff.build_tri_cull(js)
    tcull = tdiff.build_tri_cull(ts)
    perm = None if jcull is None else jcull.perm
    np.testing.assert_array_equal(tdiff.pack_spheres(ts).numpy(),
                                  np.asarray(jdiff.pack_spheres_jnp(js)))
    want = np.asarray(jdiff.pack_triangles_jnp(js, perm=perm))
    got = tdiff.pack_triangles(ts, perm=None if tcull is None
                               else tcull.perm).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


SCENE_LEAVES = ("sphere_center", "sphere_radius", "tri_v0", "tri_v1",
                "tri_v2")
MAT_LEAVES = ("color", "fuzz", "ir")


@pytest.mark.parametrize("name", PACK_CASES)
def test_packer_vjps_match_jax(name):
    (ts, _), (js, _) = _worlds(name)
    cull = jdiff.build_tri_cull(js)
    perm = None if cull is None else cull.perm
    r = np.random.default_rng(7)
    ct_s = r.normal(size=(tables.SPH_ROWS, js.num_spheres)).astype(np.float32)
    ct_t = r.normal(size=(tables.TRI_ROWS,
                          js.num_triangles)).astype(np.float32)
    _, vjp_s = jax.vjp(jdiff.pack_spheres_jnp, js)
    _, vjp_t = jax.vjp(lambda s: jdiff.pack_triangles_jnp(s, perm=perm), js)
    (ws,), (wt,) = vjp_s(jnp.asarray(ct_s)), vjp_t(jnp.asarray(ct_t))
    leaves = {f: getattr(ts, f).clone().requires_grad_(True)
              for f in SCENE_LEAVES}
    mats = {f: getattr(ts.materials, f).clone().requires_grad_(True)
            for f in MAT_LEAVES}
    s = dataclasses.replace(ts, materials=dataclasses.replace(
        ts.materials, **mats), **leaves)
    (torch.sum(tdiff.pack_spheres(s) * torch.from_numpy(ct_s))
     + torch.sum(tdiff.pack_triangles(s, perm=perm)
                 * torch.from_numpy(ct_t))).backward()
    for f in SCENE_LEAVES:
        want = np.asarray(getattr(ws, f)) + np.asarray(getattr(wt, f))
        got = leaves[f].grad.numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), f
    for f in MAT_LEAVES:
        want = np.asarray(getattr(ws.materials, f)) \
            + np.asarray(getattr(wt.materials, f))
        got = mats[f].grad.numpy()
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max() + 1e-7, f


def test_tri_cull_topology_and_bounds_match_jax():
    (ts, _), (js, _) = _worlds("mesh_scene2")
    tc, jc = tdiff.build_tri_cull(ts), jdiff.build_tri_cull(js)
    assert tdiff.build_tri_cull(ts) is tc          # cached on identity
    for f in ("perm", "ranges", "leaf_ids"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    assert tc.ranges.shape[1] > 1
    np.testing.assert_array_equal(
        tdiff.tri_cluster_bounds(ts, tc).numpy(),
        np.asarray(jdiff.tri_cluster_bounds_jnp(js, jc)))
    assert tdiff.build_tri_cull(
        rtt.models.ffi_example_world().to_scene()) is None


def test_cull_bounds_follow_moved_vertices():
    scene, _ = rtt.models.mesh_scene(2)
    cull = tdiff.build_tri_cull(scene)
    v0 = scene.tri_v0.clone().requires_grad_(True)
    b0 = tdiff.tri_cluster_bounds(scene, cull)
    moved = dataclasses.replace(
        scene, tri_v0=v0 + torch.tensor([10.0, 0.0, 0.0]) * (
            torch.arange(v0.shape[0])[:, None] == 0))
    b1 = tdiff.tri_cluster_bounds(moved, cull)
    leaf = int(cull.leaf_ids[np.nonzero(cull.perm == 0)[0][0]])
    assert float(b1[3, leaf]) > float(b0[3, leaf]) + 1.0
    assert not b1.requires_grad


# ---------------------------------------------------------------------------
# render_grad_ref vs render_grad_pallas(interpret=True)
# ---------------------------------------------------------------------------

GRAD_CASES = {
    # name: (world, W, H, spp, depth, parity sign, cull)
    "default_world": ("default_world", 24, 16, 2, 4, True, False),
    "ffi_parity": ("ffi_example_world", 24, 16, 2, 4, True, False),
    "mesh0_correct_sign": ("mesh_scene0", 24, 16, 2, 4, False, False),
    "mesh2_tri_cull": ("mesh_scene2", 24, 16, 2, 3, False, True),
}


@pytest.fixture(scope="module", params=sorted(GRAD_CASES))
def grad_case(request):
    world, W, H, spp, depth, pps, cull = GRAD_CASES[request.param]
    (ts, tc), (js, jc) = _worlds(world)
    g = np.random.default_rng(0).standard_normal((H, W, 3)).astype(
        np.float32)
    jcull = jdiff.build_tri_cull(js) if cull else None
    tcull = tdiff.build_tri_cull(ts) if cull else None
    kw = dict(width=W, height=H, samples_per_pixel=spp, depth=depth, seed=3,
              parity_plane_sign=pps)
    captured = {}

    def capture(w, vals, n_targets):
        jax.debug.callback(lambda a: captured.update(w=np.asarray(a)), w)
        return orig(w, vals, n_targets)

    orig = jwb._winner_reduce
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jwb, "_winner_reduce", capture)
        want = jwb.render_grad_pallas(
            jdiff.pack_spheres_jnp(js),
            jdiff.pack_triangles_jnp(js, perm=None if jcull is None
                                     else jcull.perm),
            jnp.asarray(g), jwf.camera_vec(jc), interpret=True,
            block_rows=8,
            tri_clusters=None if jcull is None else (
                jdiff.tri_cluster_bounds_jnp(js, jcull),
                jnp.asarray(jcull.ranges)), **kw)
        want = [np.asarray(x) for x in jax.block_until_ready(want)]
    # the Pallas slab's lanes are (spp x row blocks, depth, 8 x 128)
    nty = -(-H // 8)
    jw = captured["w"].reshape(spp, nty, depth, 8, 128).transpose(
        0, 2, 1, 3, 4).reshape(spp, depth, nty * 8, 128)[:, :, :H, :W]
    args = (tdiff.pack_spheres(ts),
            tdiff.pack_triangles(ts, perm=None if tcull is None
                                 else tcull.perm),
            torch.from_numpy(g), tables.camera_vec(tc))
    tcl = None if tcull is None else (tdiff.tri_cluster_bounds(ts, tcull),
                                      torch.from_numpy(tcull.ranges))
    slab, cam = twb.grad_slab_ref(*args, tri_clusters=tcl, **kw)
    got = twb.reduce_slab(slab, cam, args[0].shape[1], args[1].shape[1])
    return dict(world=world, want=want, got=[x.numpy() for x in got],
                want_ids=jw, got_ids=slab[:, :, twb.GP_WIN].numpy())


def test_render_grad_ref_winner_ids_match_pallas(grad_case):
    assert (grad_case["got_ids"] >= 0).any()
    np.testing.assert_array_equal(grad_case["got_ids"], grad_case["want_ids"])


@pytest.mark.parametrize("out", ["dsph", "dtri", "dcam"])
def test_render_grad_ref_matches_pallas(grad_case, out):
    k = ("dsph", "dtri", "dcam").index(out)
    got, want = grad_case["got"][k], grad_case["want"][k]
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = FMA_GAP if grad_case["world"] in SHARED_SPHERES else 1e-4
    assert np.abs(got - want).max() <= rel * np.abs(want).max() + 1e-7


# ---------------------------------------------------------------------------
# wrappers, the reduction and render_linear_diff
# ---------------------------------------------------------------------------

def _tables(world="default_world"):
    w = getattr(rtt.models, world)()
    scene, cam = w.to_scene(), w.to_camera()
    return (tdiff.pack_spheres(scene), tdiff.pack_triangles(scene),
            tables.camera_vec(cam))


def test_cuda_wrapper_on_cpu_tensors_runs_plain_version():
    sph, tri, cv = _tables()
    g = torch.ones(6, 10, 3)
    kw = dict(width=10, height=6, samples_per_pixel=1, depth=3, seed=2)
    before = twb.LAUNCHES
    got = twb.render_grad_cuda(sph, tri, g, cv, **kw)
    want = twb.render_grad_ref(sph, tri, g, cv, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert twb.LAUNCHES == before


@pytest.mark.parametrize("bad", ["depth", "g_shape", "g_dtype",
                                 "parity_cull"])
def test_bad_inputs_raise(bad):
    sph, tri, cv = _tables()
    kw = dict(width=8, height=4, samples_per_pixel=1, depth=2)
    g = torch.zeros(4, 8, 3)
    if bad == "depth":
        kw["depth"] = twb.MAX_DEPTH + 1
    elif bad == "g_shape":
        g = torch.zeros(4, 8)
    elif bad == "g_dtype":
        g = g.double()
    else:
        kw["tri_clusters"] = (torch.zeros(6, 1),
                              torch.zeros(2, 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        twb.render_grad_ref(sph, tri, g, cv, **kw)


def test_winner_reduce_sums_by_id():
    r = np.random.default_rng(3)
    w = r.integers(-1, 5, size=200)
    vals = r.normal(size=(200, 9)).astype(np.float32)
    got = twb._winner_reduce(torch.from_numpy(w), torch.from_numpy(vals), 5)
    want = np.stack([vals[w == k].sum(0) for k in range(5)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_reduce_slab_row_mapping():
    S, T = 2, 3
    slab = torch.zeros(1, 1, twb.GRAD_PLANES, 1, 4)
    slab[0, 0, twb.GP_WIN, 0] = torch.tensor([0.0, S + 1.0, S + 1.0, -1.0])
    slab[0, 0, 1:, 0] = torch.arange(1.0, 10.0)[:, None].expand(9, 4)
    dsph, dtri, dcam = twb.reduce_slab(slab, torch.ones(12, 1, 4), S, T)
    assert torch.equal(dsph[:, 0], torch.arange(1.0, 10.0))
    assert not dsph[:, 1].any()
    col = dtri[:, 1]
    assert torch.equal(col[[tables.TRI_NX, tables.TRI_NY, tables.TRI_NZ,
                            tables.TRI_D]], torch.tensor([2.0, 4, 6, 8]))
    assert col[tables.TRI_EXTRA] == 2 * (8 + 9)          # d_fuzz + d_ir
    assert torch.equal(col[[tables.TRI_AR, tables.TRI_AG, tables.TRI_AB]],
                       torch.tensor([10.0, 12, 14]))
    # edge constants and the kind take no cotangent
    assert not col[tables.TRI_G0X:tables.TRI_KIND + 1].any()
    assert torch.equal(dcam, torch.full((12,), 4.0))


def test_render_linear_diff_forward_and_table_cotangents():
    w = rtt.models.ffi_example_world()
    scene, cam = w.to_scene(), w.to_camera()
    sph, tri, cv = (t.clone().requires_grad_(True) for t in _tables(
        "ffi_example_world"))
    cfg = dict(width=12, height=8, samples_per_pixel=2, depth=3, seed=1,
               parity_plane_sign=True, shard_rows=None, row_offset=0,
               row_stride=1)
    img = tdiff._KernelRender.apply(sph, tri, cv, None, cfg)
    want, _ = twf.render_linear_ref(sph.detach(), tri.detach(), cv.detach(),
                                    **cfg)
    assert torch.equal(img, want)
    img.sum().backward()
    # the table's r^2 and kind rows take no cotangent: K5's dr is total
    assert not sph.grad[[tables.SPH_R2, tables.SPH_KIND]].any()
    assert sph.grad[tables.SPH_R].any()
    assert not tri.grad[tables.TRI_G0X:tables.TRI_KIND + 1].any()
    assert tri.grad[tables.TRI_D].any() and cv.grad.any()
    img2 = tdiff.render_linear_diff(scene, cam, width=12, height=8,
                                    samples_per_pixel=2, depth=3, seed=1)
    assert torch.equal(img2, want)


def test_banded_diff_rows_and_gradients_sum_to_whole():
    w = rtt.models.default_world()
    scene, cam = w.to_scene(), w.to_camera()
    kw = dict(width=10, height=9, samples_per_pixel=1, depth=3, seed=4)
    weight = torch.from_numpy(np.random.default_rng(1).normal(
        size=(9, 10, 3)).astype(np.float32))

    def grad_of(**band):
        c = scene.sphere_center.clone().requires_grad_(True)
        img = tdiff.render_linear_diff(
            dataclasses.replace(scene, sphere_center=c), cam, **kw, **band)
        rows = list(range(band.get("row_offset", 0), 9,
                          band.get("row_stride", 1)))[:img.shape[0]]
        (img[:len(rows)] * weight[rows]).sum().backward()
        return img.detach(), rows, c.grad

    whole, _, g_whole = grad_of()
    total = torch.zeros_like(g_whole)
    for off in (0, 1):
        part, rows, g = grad_of(shard_rows=5, row_offset=off, row_stride=2)
        assert torch.equal(part[:len(rows)], whole[rows])
        total += g
    assert torch.allclose(total, g_whole, rtol=1e-5, atol=1e-6)


def test_bwd_kernel_eligible_for_every_scene():
    scene, _ = rtt.models.mesh_scene(3)
    assert tdiff.bwd_kernel_eligible(scene)
    assert tdiff.bwd_kernel_eligible(scene, parity_plane_sign=True)
