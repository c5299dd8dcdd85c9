"""The port's gradient pass against the JAX package, mirroring the five
comparisons of tests/test_grad.py::TestBackwardKernel and its
test_camera_cotangent, on the same numpy inputs.

For each case one module-scoped fixture computes, once:
  * JAX, engine "xla": value and ``jax.grad`` through the XLA renderer;
  * JAX, engine "pallas" (interpret=True): the Pallas forward and the
    hand-derived backward kernel;
  * the port, engine "xla": autograd through ``render.render_linear``;
  * the port, engine "pallas": ``render_linear_diff``, K1 and K5 (here on
    the CPU, their plain versions).
Bars: losses within 1e-5; the port's autograd within 1e-4 * max|ref| + 1e-7
of JAX's; the port's kernel path within the JAX suite's own
5e-3 * max|ref| + 1e-7 of the XLA AD gradient, and within
1e-4 * max|ref| + 1e-7 of the JAX kernel path, per leaf -- except on the
default world, see FMA_GAP."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import grad as jgrad
from raytracer_tpu.ops import diff as jdiff
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import grad as tgrad
from raytracer_tpu_torch.ops import diff as tdiff

CASES = {
    # name: (world, fields, bumped fields, bump, W, H, spp, depth, seed,
    #        parity sign, JAX kernel path streamed)
    "all_materials": ("default_world", ("sphere_center", "sphere_radius",
                                        "mat_color", "mat_fuzz", "mat_ir"),
                      ("sphere_center",), 0.02, 24, 16, 2, 4, 3, True, False),
    "triangles_parity": ("ffi_example_world",
                         ("tri_v0", "tri_v1", "tri_v2", "sphere_center",
                          "mat_color"), None, 0.015, 24, 16, 2, 3, 11, True,
                         False),
    "triangles_correct_sign": ("mesh_scene0", ("tri_v0", "tri_v1", "tri_v2"),
                               None, 0.01, 16, 12, 1, 2, 2, False, False),
    "clustered": ("mesh_scene2", ("tri_v0", "mat_color"), ("tri_v0",), 0.004,
                  24, 16, 2, 3, 5, False, False),
    # both packages forced onto the two-level walk (K2 + K5s; on the CPU the
    # port's plain versions) over the same leaves as "clustered"
    "streamed": ("mesh_scene2", ("tri_v0", "mat_color"), ("tri_v0",), 0.004,
                 24, 16, 2, 3, 5, False, True),
}
# The default world's kernel gradients differ from the JAX kernel path by up
# to 3.4e-4 * max|ref| (measured: sphere_center 3.41e-4, mat_ir 3.42e-4,
# mat_fuzz 9.3e-5, mat_color 1.7e-6 at the case above).  Cause: XLA:CPU
# contracts a * b - c into one fused multiply-add (jit of a * a - c equals
# the fused result on 100000 of 100000 random float32 inputs), while K5 and
# its plain version round every operation; on lanes that graze the metal and
# glass spheres the implicit-t adjoint's 1 / (u . d) amplifies that rounding.
# Winner ids agree lane for lane (test_torch_diff.py).
FMA_GAP = 1e-3
KINDS = ("loss", "autograd_vs_jax_ad", "kernels_vs_jax_ad",
         "kernels_vs_jax_kernels")


def _worlds(name):
    if name.startswith("mesh_scene"):
        sub = int(name[-1])
        return rtt.models.mesh_scene(sub), rt.models.mesh_scene(sub)
    tw, jw = getattr(rtt.models, name)(), getattr(rt.models, name)()
    return (tw.to_scene(), tw.to_camera()), (jw.to_scene(), jw.to_camera())


@functools.lru_cache(maxsize=None)
def _jax_xla(world, fields, bumped, bump, W, H, spp, depth, seed, pps):
    """JAX target, start params (``bumped`` fields + ``bump``, all when
    None) and (value, grads) through the XLA AD; cached, so the streamed
    case reuses the clustered one's."""
    (_, _), (js, jc) = _worlds(world)
    kw = dict(width=W, height=H, samples_per_pixel=spp, depth=depth,
              seed=seed)
    target, _ = rt.render_linear(js, jc, parity_plane_sign=pps, **kw)
    params = {k: v + bump if bumped is None or k in bumped else v
              for k, v in jgrad.extract_params(js, list(fields)).items()}
    loss = jgrad.make_loss_fn(js, jc, target, parity_plane_sign=pps, **kw)
    v, g = jax.value_and_grad(loss)(params)
    return (np.asarray(target), {k: np.asarray(p) for k, p in params.items()},
            float(v), {k: np.asarray(x) for k, x in g.items()})


def _port_value_and_grad(loss_fn, params_np):
    params = tgrad.params_from_arrays(params_np, "cpu")
    for p in params.values():
        p.requires_grad_(True)
    loss = loss_fn(params)
    loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in params.items()}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, monkeypatch_module):
    world, _, _, _, W, H, spp, depth, seed, pps, streamed = \
        CASES[request.param]
    target, params, v_ad, g_ad = _jax_xla(*CASES[request.param][:-1])
    kw = dict(width=W, height=H, samples_per_pixel=spp, depth=depth,
              seed=seed, parity_plane_sign=pps)
    (ts, tc), (js, jc) = _worlds(world)
    if streamed:
        monkeypatch_module.setattr(jdiff, "_needs_stream", lambda s: True)
        monkeypatch_module.setattr(tdiff, "_needs_stream", lambda s: True)
    jloss = jgrad.make_loss_fn(js, jc, jnp.asarray(target), engine="pallas",
                               interpret=True, **kw)
    v_k, g_k = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(p) for k, p in params.items()})
    out = {"world": world, "jax_ad": (v_ad, g_ad),
           "jax_kernels": (float(v_k), {k: np.asarray(x)
                                        for k, x in g_k.items()})}
    target_t = torch.from_numpy(target.copy())
    for engine, name in (("xla", "autograd"), ("pallas", "kernels")):
        out[name] = _port_value_and_grad(
            tgrad.make_loss_fn(ts, tc, target_t, engine=engine, device="cpu",
                               **kw),
            params)
    monkeypatch_module.undo()
    return out


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _close(got, want, rel):
    """Every leaf finite and within rel * max|want| + 1e-7."""
    gaps = {}
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        scale = max(np.abs(w).max(), 1e-8)
        gaps[k] = (np.abs(got[k] - w).max(), scale)
    assert all(d <= rel * s + 1e-7 for d, s in gaps.values()), {
        k: float(d / s) for k, (d, s) in gaps.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_gradient_pass_matches_jax(case, kind):
    if kind == "loss":
        for name in ("jax_kernels", "autograd", "kernels"):
            assert abs(case[name][0] - case["jax_ad"][0]) < 1e-5, name
    elif kind == "autograd_vs_jax_ad":
        _close(case["autograd"][1], case["jax_ad"][1], 1e-4)
    elif kind == "kernels_vs_jax_ad":
        _close(case["kernels"][1], case["jax_ad"][1], 5e-3)
    else:
        rel = FMA_GAP if case["world"] == "default_world" else 1e-4
        _close(case["kernels"][1], case["jax_kernels"][1], rel)


@pytest.fixture(scope="module")
def camera_grads():
    """test_camera_cotangent: d sum(img^2) / d camera, sphere_and_ground at
    16x12, 2 spp, depth 3, seed 7, parity sign."""
    W, H, spp, depth, seed = 16, 12, 2, 3, 7
    jw, tw = rt.models.sphere_and_ground(), rtt.models.sphere_and_ground()
    js, jc = jw.to_scene(), jw.to_camera()

    def jloss(c, st):
        img = jdiff.render_linear_diff(js, c, st)
        return jnp.sum(img * img)

    def jloss_xla(c):
        img, _ = rt.render_linear(js, c, width=W, height=H,
                                  samples_per_pixel=spp, depth=depth,
                                  seed=seed)
        return jnp.sum(img * img)

    # the JAX test's "xla" statics run the kernel forward and the XLA
    # backward; jax.grad through render_linear differs from it only by the
    # forward images' <= 1e-5 in the cotangent 2 img
    g_k = jax.grad(lambda c: jloss(c, (W, H, spp, depth, seed, True, True,
                                       "pallas")))(jc)
    g_x = jax.grad(jloss_xla)(jc)
    want = {name: {f: np.asarray(getattr(g, f)) for f in FIELDS}
            for name, g in (("pallas", g_k), ("xla", g_x))}
    ts, tc = tw.to_scene(), tw.to_camera()
    cam = rtt.Camera(*(getattr(tc, f).clone().requires_grad_(True)
                       for f in FIELDS))
    kw = dict(width=W, height=H, samples_per_pixel=spp, depth=depth,
              seed=seed, parity_plane_sign=True)
    img = tdiff.render_linear_diff(ts, cam, **kw)
    torch.sum(img * img).backward()
    got = {"kernels": {f: getattr(cam, f).grad.numpy() for f in FIELDS}}
    cam2 = rtt.Camera(*(getattr(tc, f).clone().requires_grad_(True)
                        for f in FIELDS))
    img, _ = rtt.render_linear(ts, cam2, **kw)
    torch.sum(img * img).backward()
    got["autograd"] = {f: getattr(cam2, f).grad.numpy() for f in FIELDS}
    return got, want


FIELDS = ("origin", "lower_left_corner", "horizontal", "vertical")


@pytest.mark.parametrize("port,ref,rel", [
    ("kernels", "xla", 5e-3), ("kernels", "pallas", 1e-4),
    ("autograd", "xla", 1e-4)])
def test_camera_cotangent_matches_jax(camera_grads, port, ref, rel):
    got, want = camera_grads
    _close(got[port], want[ref], rel)


def test_auto_engine_is_autograd_on_cpu():
    w = rtt.models.sphere_and_ground()
    scene, cam = w.to_scene(), w.to_camera()
    kw = dict(width=8, height=6, samples_per_pixel=1, depth=2, seed=1)
    target, _ = rtt.render_linear(scene, cam, **kw)
    params = tgrad.extract_params(scene, ["mat_color"])
    params["mat_color"] = params["mat_color"] * 0.7
    from raytracer_tpu_torch.ops.cuda import wavefront_bwd as wb
    before = wb.LAUNCHES
    auto = tgrad.make_loss_fn(scene, cam, target, engine="auto", device="cpu",
                              **kw)
    xla = tgrad.make_loss_fn(scene, cam, target, engine="xla", device="cpu",
                             **kw)
    assert float(auto(params)) == float(xla(params))
    assert wb.LAUNCHES == before
    with pytest.raises(ValueError, match="engine"):
        tgrad.make_loss_fn(scene, cam, target, engine="cuda", device="cpu",
                           **kw)
