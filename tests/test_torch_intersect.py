"""The port's differentiable wavefront path (maths, materials, intersect,
render.render_linear) against the JAX package on the same numpy inputs.

Bars: helpers within rtol=1e-6, per-ray records within rtol=1e-5 (winner
ids and masks equal); images within atol=1e-5 with equal segment counts,
5e-4 on the random sphere field (see test_torch_wavefront.py).  Gradients
through ``render_linear`` are checked in test_torch_grad.py."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import intersect as jint
from raytracer_tpu import materials as jmat
from raytracer_tpu import maths as jm
from raytracer_tpu.scene import triangle_normals as jtri_normals
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import intersect as tint
from raytracer_tpu_torch import materials as tmat
from raytracer_tpu_torch import maths as tm
from raytracer_tpu_torch.scene import triangle_normals as ttri_normals


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _worlds(name, **kw):
    if name.startswith("mesh_scene"):
        sub = int(name[-1])
        return rtt.models.mesh_scene(sub), rt.models.mesh_scene(sub)
    if name == "random_spheres":
        return (rtt.models.random_spheres(**kw),
                rt.models.random_spheres(**kw))
    tw, jw = getattr(rtt.models, name)(), getattr(rt.models, name)()
    return (tw.to_scene(), tw.to_camera()), (jw.to_scene(), jw.to_camera())


# ---------------------------------------------------------------------------
# maths
# ---------------------------------------------------------------------------

def test_safe_sqrt_value_and_guarded_cotangent():
    x = np.array([4.0, 2.25, 0.0, -1.0, 1e-30], np.float32)
    xt = _t(x).requires_grad_(True)
    y = tm.safe_sqrt(xt)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy()[[0, 1, 2, 4]],
                                  np.sqrt(x[[0, 1, 2, 4]]))
    want = jax.grad(lambda v: jnp.sum(jm.safe_sqrt(v)))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert xt.grad[2] == 0.0 and xt.grad[3] == 0.0


@pytest.mark.parametrize("fn", ["near_zero", "reflect", "refract", "length",
                                "normalize"])
def test_maths_helpers_agree(fn):
    r = np.random.default_rng(9)
    a = r.normal(size=(33, 3)).astype(np.float32)
    n = r.normal(size=(33, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    eta = r.uniform(0.5, 2.0, size=33).astype(np.float32)
    a[:4] = [[1e-9, -1e-9, 0.0], [2e-8, 0.0, 0.0], [0.0, 0.0, 0.0],
             [5e-9, 5e-9, 5e-9]]
    args = {"near_zero": (a,), "reflect": (a, n), "refract": (n[::-1], n, eta),
            "length": (a,), "normalize": (a[4:],)}[fn]
    got = getattr(tm, fn)(*(_t(x) for x in args))
    want = getattr(jm, fn)(*(jnp.asarray(x) for x in args))
    if fn == "near_zero":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_refract_gradient_finite_at_grazing():
    # 1 - |r_perp|^2 == 0 exactly: safe_sqrt keeps the cotangent finite
    uv = _t(np.array([[1.0, 0.0, 0.0]], np.float32)).requires_grad_(True)
    n = _t(np.array([[0.0, 1.0, 0.0]], np.float32))
    tm.refract(uv, n, 1.0).sum().backward()
    assert torch.isfinite(uv.grad).all()


@pytest.mark.parametrize("name", ["ffi_example_world", "mesh_scene1"])
def test_triangle_normals_agree(name):
    (ts, _), (js, _) = _worlds(name)
    np.testing.assert_allclose(ttri_normals(ts).numpy(),
                               np.asarray(jtri_normals(js)), rtol=1e-6,
                               atol=1e-7)


def test_replace_carries_grad_tensors_and_numpy_detaches():
    scene = rtt.models.default_world().to_scene()
    c = scene.sphere_center.clone().requires_grad_(True)
    color = scene.materials.color.clone().requires_grad_(True)
    s2 = dataclasses.replace(
        scene, sphere_center=c,
        materials=dataclasses.replace(scene.materials, color=color))
    assert s2.sphere_center is c and s2.materials.color is color
    cam = rtt.models.default_world().to_camera()
    o = cam.origin.clone().requires_grad_(True)
    assert dataclasses.replace(cam, origin=o).origin is o
    host = s2.numpy()     # detaches: no error on tensors that need grad
    np.testing.assert_array_equal(host.sphere_center, c.detach().numpy())
    np.testing.assert_array_equal(host.mat_color, color.detach().numpy())


# ---------------------------------------------------------------------------
# materials
# ---------------------------------------------------------------------------

def test_random_unit_sphere_agrees():
    r = np.random.default_rng(2)
    b = r.uniform(-1, 1, size=(3, 40)).astype(np.float32)
    got = tmat.random_unit_sphere(*(_t(x) for x in b))
    want = jmat.random_unit_sphere(*(jnp.asarray(x) for x in b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_scatter_agrees_on_every_material():
    tw, jw = rtt.models.default_world(), rt.models.default_world()
    tmats, jmats = tw.to_scene().materials, jw.to_scene().materials
    r = np.random.default_rng(4)
    B = 64
    mat = r.integers(0, tmats.count, size=B).astype(np.int32)
    d = r.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = r.normal(size=(B, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ru = r.normal(size=(B, 3)).astype(np.float32)
    ru /= np.linalg.norm(ru, axis=-1, keepdims=True)
    ru[0] = -n[0]                      # degenerate diffuse sum
    got = tmat.scatter(tmats, _t(mat), _t(d), _t(n), _t(ru))
    want = jmat.scatter(jmats, jnp.asarray(mat), jnp.asarray(d),
                        jnp.asarray(n), jnp.asarray(ru))
    assert set(np.asarray(jmats.kind)[mat]) == {0, 1, 2}
    np.testing.assert_array_equal(got.terminal.numpy(),
                                  np.asarray(want.terminal))
    for f in ("color", "direction"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# intersect
# ---------------------------------------------------------------------------

def _rays(n=96, seed=3):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    o[:, 2] += 0.5
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("name", ["default_world", "ffi_example_world",
                                  "mesh_scene1"])
def test_pack_scene_agrees(name):
    (ts, _), (js, _) = _worlds(name)
    tp, jp = tint.pack_scene(ts), jint.pack_scene(js)
    for f in dataclasses.fields(tp):
        np.testing.assert_allclose(getattr(tp, f.name).numpy(),
                                   np.asarray(getattr(jp, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)


@pytest.mark.parametrize("name,pps", [("default_world", True),
                                      ("ffi_example_world", True),
                                      ("mesh_scene1", False)])
def test_hits_agree(name, pps):
    (ts, _), (js, _) = _worlds(name)
    o, d = _rays()
    to, td, jo, jd = _t(o), _t(d), jnp.asarray(o), jnp.asarray(d)
    tp, jp = tint.pack_scene(ts), jint.pack_scene(js)
    got = tint.closest_hit_batch(to, td, ts, tp, parity_plane_sign=pps)
    want = jint.closest_hit_batch(jo, jd, js, jp, parity_plane_sign=pps)
    assert got.hit.any()
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.mat.numpy(), np.asarray(want.mat))
    for f in ("t", "position", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    for tfn, jfn, extra in ((tint.sphere_hits_batch, jint.sphere_hits_batch,
                             {}),
                            (tint.triangle_hits_batch,
                             jint.triangle_hits_batch,
                             {"parity_plane_sign": pps})):
        (tt, ti), (jt, ji) = tfn(to, td, ts, tp, **extra), \
            jfn(jo, jd, js, jp, **extra)
        hit = np.isfinite(np.asarray(jt))
        np.testing.assert_array_equal(np.isfinite(tt.numpy()), hit)
        np.testing.assert_array_equal(ti.numpy()[hit], np.asarray(ji)[hit])
        np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                                   rtol=1e-5)


def test_contract3_is_not_a_matmul():
    a = _t(np.array([[1.0 + 2 ** -20, 1.0, 1.0]], np.float32))
    b = _t(np.array([[1.0 + 2 ** -20], [1.0], [-1.0]], np.float32))
    want = np.float32(1.0 + 2 ** -20) * np.float32(1.0 + 2 ** -20) \
        + np.float32(1.0) - np.float32(1.0)
    assert float(tint.contract3(a, b)) == float(want)


# ---------------------------------------------------------------------------
# render_linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,pps,spp,depth", [
    ("default_world", True, 2, 4), ("ffi_example_world", True, 2, 3),
    ("mesh_scene1", False, 2, 3)])
def test_render_linear_matches_jax(name, pps, spp, depth):
    (ts, tc), (js, jc) = _worlds(name)
    kw = dict(width=16, height=12, samples_per_pixel=spp, depth=depth,
              seed=5, parity_plane_sign=pps)
    img, segs = rtt.render_linear(ts, tc, **kw)
    want, wsegs = rt.render_linear(js, jc, **kw)
    assert img.shape == (12, 16, 3) and img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=1e-5)
    assert segs == int(wsegs)


def test_render_linear_random_spheres_ground_1000():
    (ts, tc), (js, jc) = _worlds("random_spheres", n=48, seed=3)
    kw = dict(width=12, height=8, samples_per_pixel=1, depth=3,
              parity_plane_sign=False)
    img, segs = rtt.render_linear(ts, tc, **kw)
    want, wsegs = rt.render_linear(js, jc, **kw)
    np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=5e-4)
    assert segs == int(wsegs)
