"""The port's silhouette gradients (raytracer_tpu_torch/grad/silhouette.py)
against the JAX package's, one twin per silhouette class of
tests/test_grad.py, at that class's own scenes, shapes, seeds, ``n_edge``
and ``samples_per_edge``, on the same numpy inputs (params carried across
with ``extract_params`` / ``params_from_arrays``).

For each ``value_and_grad_with_silhouette`` case one module-scoped fixture
computes, once: the JAX call (loss and grads), its interior part
(``jax.value_and_grad`` of the XLA loss), and every estimator the call runs
(jitted, on the same ``g_img`` = 2 (img - target) / img.size and the same
params, at the call's seeds and sizes); then the port's counterparts on the
CPU.  The finite-difference sweeps of tests/test_grad.py are not repeated.

Bars: losses within 1e-5; the interior part within 1e-4 * max|ref| + 1e-7
(test_torch_grad.py's autograd bar); each estimator's outputs and the
totals within 1e-3 * max|ref| + 1e-6; the edge selections pick the same
(ti, e) pairs; the zero-term cases are exactly 0."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import grad as jgrad
from raytracer_tpu.grad import silhouette as jsil
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import grad as tgrad
from raytracer_tpu_torch.grad import silhouette as tsil

EST_BAR = 1e-3
INTERIOR_BAR = 1e-4

MIRROR_SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material MIRROR : Metal color 0.9 0.8 0.7 fuzz 0.0;
sphere center 0.0 0.0 -2.0 radius 0.9 material MIRROR;
"""
MIRROR_BALL_SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material MIRROR : Metal color 0.95 0.95 0.95 fuzz 0.0;
material BALL : Diffuse color 0.8 0.2 0.1;
sphere center 0.0 0.0 -102.0 radius 100.0 material MIRROR;
sphere center 0.7 0.1 1.6 radius 0.45 material BALL;
"""
GLASS_SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material GLASS : Dielectric ir 1.15;
material BALL : Diffuse color 0.8 0.2 0.1;
sphere center 0.0 0.0 -1.0 radius 0.45 material GLASS;
sphere center 0.0 0.0 -1.8 radius 0.35 material BALL;
"""
TRIANGLE_SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material RED : Diffuse color 0.8 0.2 0.2;
triangle v0 -0.5 -0.3 -1.5  v1 0.6 -0.2 -1.6  v2 0.0 0.55 -1.4 material RED;
"""
PLAIN_SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material A : Diffuse color 0.5 0.5 0.5;
sphere center 0.0 0.0 -2.0 radius 0.5 material A;
"""
OCCLUDED_SRC = """camera origin 0.0 0.0 0.0 aspect 1.0;
material MIRROR : Metal color 0.9 0.8 0.7 fuzz 0.0;
material FRONT : Diffuse color 0.2 0.4 0.6;
sphere center 0.0 0.0 -4.0 radius 0.9 material MIRROR;
sphere center 0.0 0.0 -1.2 radius 0.8 material FRONT;
"""


def _parsed(src):
    jw, tw = rt.parse_input(src), rtt.parse_input(src)
    return (jw.to_scene(), jw.to_camera()), (tw.to_scene(), tw.to_camera())


def _mirror_mesh():
    """TestMirrorMeshSilhouette._world: a mirror ahead, a cube behind the
    camera (visible only reflected)."""
    from raytracer_tpu.models.builders import cube_mesh as jcube
    from raytracer_tpu.scene import (DIFFUSE, METAL, build_materials as jbm,
                                     build_scene as jbs)
    from raytracer_tpu_torch.models.builders import cube_mesh as tcube
    from raytracer_tpu_torch.scene import (build_materials as tbm,
                                           build_scene as tbs)
    rows = [(METAL, (0.95, 0.95, 0.95), 0.0, 1.0),
            (DIFFUSE, (0.8, 0.2, 0.1), 0.0, 1.0)]
    sph = [((0.0, 0.0, -102.0), 100.0, 0)]
    js = jbs(sph, jcube((0.4, 0.1, 1.6), 0.3, 1), jbm(rows),
             exact_planes=True)
    ts = tbs(sph, tcube((0.4, 0.1, 1.6), 0.3, 1), tbm(rows),
             exact_planes=True)
    return ((js, rt.Camera.new_at((0.0, 0.0, 0.0), 1.0)),
            (ts, rtt.Camera.new_at((0.0, 0.0, 0.0), 1.0)))


# name: (worlds, fields, bump (added to every field but sphere_radius, which
# is scaled by 1.06), W, H, spp, depth, seed, parity sign, n_edge,
# samples_per_edge) -- each the JAX test's own setup
CASES = {
    # TestSilhouetteGradients.test_unmasked_fd_match
    "TestSilhouetteGradients": (
        lambda: _parsed(MIRROR_SRC), ("sphere_center", "sphere_radius"),
        [[0.04, -0.03, 0.05]], 32, 32, 4, 2, 5, True, 2048, 16),
    # TestSilhouetteGradients.test_triangle_edge_gradients_unmasked (seed 9)
    "TestSilhouetteGradients_triangle": (
        lambda: _parsed(TRIANGLE_SRC), ("tri_v0", "tri_v1", "tri_v2"),
        [[0.03, -0.02, 0.04]], 32, 32, 16, 2, 9, False, 512, 32),
    # TestMirrorSilhouette.test_mirror_only_sphere_fd_match
    "TestMirrorSilhouette": (
        lambda: _parsed(MIRROR_BALL_SRC), ("sphere_center",),
        [[0.0, 0.0, 0.0], [0.05, -0.04, 0.0]], 32, 32, 4, 3, 11, True, 1024,
        16),
    # TestGlassSilhouette.test_glass_only_sphere_fd_match
    "TestGlassSilhouette": (
        lambda: _parsed(GLASS_SRC), ("sphere_center",),
        [[0.0, 0.0, 0.0], [0.03, -0.02, 0.0]], 48, 48, 4, 5, 13, True, 512,
        16),
    # TestMirrorMeshSilhouette.test_mirror_mesh_fd_match
    "TestMirrorMeshSilhouette": (
        _mirror_mesh, ("tri_v0", "tri_v1", "tri_v2"), [0.04, -0.03, 0.0],
        32, 32, 4, 3, 17, False, 512, 16),
}


def _estimators(scene_np_kinds, S, T, fields, seed, n_edge, spe):
    """The estimators ``_loss_and_grad`` runs for these params, with their
    keyword arguments (the host gates of value_and_grad_with_silhouette)."""
    kinds, fuzz, valid = scene_np_kinds
    mirrors = (kinds == 1) & (fuzz == 0.0) & valid
    glass = ((kinds == 2) & valid).any()
    out = []
    if {"sphere_center", "sphere_radius"} & set(fields):
        out.append(("silhouette_grad", dict(seed=seed + 7919,
                                            n_edge=n_edge)))
        if S <= 32 and mirrors.any():
            out.append(("mirror_silhouette_grad",
                        dict(seed=seed + 15485863,
                             n_edge=max(n_edge // 2, 64))))
        if glass and S <= 16:
            out.append(("glass_silhouette_grad",
                        dict(seed=seed + 32452843,
                             n_edge=max(n_edge // 4, 64))))
    if {"tri_v0", "tri_v1", "tri_v2"} & set(fields) and T > 0:
        out.append(("triangle_silhouette_grad",
                    dict(seed=seed + 104729, samples_per_edge=spe)))
        idx = tuple(int(i) for i in np.nonzero(mirrors)[0][:4])
        if idx:
            out.append(("mirror_triangle_silhouette_grad",
                        dict(seed=seed + 49979687, samples_per_edge=spe,
                             max_edges=min(jsil.MAX_EDGE_SAMPLES, 512),
                             mirror_idx=idx)))
    return out


def _jax_estimator(name, scene, cam, g_img, **kw):
    """A JAX estimator, jitted (its keyword arguments static, the seed
    traced as inside ``_loss_and_grad``)."""
    seed = kw.pop("seed")
    fn = jax.jit(functools.partial(getattr(jsil, name), **kw))
    return [np.asarray(x) for x in fn(scene, cam, jnp.asarray(g_img),
                                      seed=seed)]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    (worlds, fields, bump, W, H, spp, depth, seed, pps, n_edge,
     spe) = CASES[request.param]
    (js, jc), (ts, tc) = worlds()
    kw = dict(width=W, height=H, samples_per_pixel=spp, depth=depth,
              seed=seed, parity_plane_sign=pps)
    target, _ = rt.render_linear(js, jc, **kw)
    params = {k: v * 1.06 if k == "sphere_radius"
              else v + jnp.asarray(bump, jnp.float32)
              for k, v in jgrad.extract_params(js, list(fields)).items()}
    sil = dict(n_edge=n_edge, samples_per_edge=spe)
    loss, grads = jgrad.value_and_grad_with_silhouette(js, jc, target,
                                                       params, **kw, **sil)
    jloss = jgrad.make_loss_fn(js, jc, target, **kw)
    i_loss, interior = jax.jit(jax.value_and_grad(jloss))(params)
    s_now = jgrad.apply_params(js, params)
    img, _ = rt.render_linear(s_now, jc, **kw)
    g_img = np.array(2.0 * (img - target) / img.size)
    shape = dict(width=W, height=H, depth=depth, parity_plane_sign=pps)
    host = (np.asarray(js.materials.kind)[np.asarray(js.sphere_mat)],
            np.asarray(js.materials.fuzz)[np.asarray(js.sphere_mat)],
            np.asarray(js.sphere_valid))
    ests = _estimators(host, js.num_spheres, js.num_triangles, fields, seed,
                       n_edge, spe)
    want = {"loss": float(loss), "interior_loss": float(i_loss),
            "interior": {k: np.asarray(v) for k, v in interior.items()},
            "total": {k: np.asarray(v) for k, v in grads.items()},
            "estimators": {n: _jax_estimator(n, s_now, jc, g_img, **e,
                                             **shape) for n, e in ests}}

    params_np = {k: np.asarray(v) for k, v in params.items()}
    t_target = torch.from_numpy(np.array(target))
    tp = tgrad.params_from_arrays(params_np, "cpu")
    t_loss, t_grads = tgrad.value_and_grad_with_silhouette(
        ts, tc, t_target, tp, device="cpu", **kw, **sil)
    lp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    li = tgrad.make_loss_fn(ts, tc, t_target, device="cpu", **kw)(lp)
    li.backward()
    t_now = tgrad.apply_params(ts, tp)
    got = {"loss": float(t_loss), "interior_loss": float(li.detach()),
           "interior": {k: v.grad.numpy() for k, v in lp.items()},
           "total": {k: v.numpy() for k, v in t_grads.items()},
           "estimators": {n: [x.numpy() for x in getattr(tsil, n)(
               t_now, tc, torch.from_numpy(g_img), **e, **shape)]
               for n, e in ests}}
    return request.param, want, got


def _close(got, want, rel, atol):
    """Every leaf finite, of the same shape, and within rel * max|want| +
    atol."""
    gaps = {}
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.shape == np.shape(w), (k, g.shape, np.shape(w))
        assert np.isfinite(g).all(), k
        gaps[k] = (float(np.abs(g - w).max(initial=0.0)),
                   float(np.abs(w).max(initial=0.0)))
    assert all(d <= rel * s + atol for d, s in gaps.values()), gaps


def test_loss_matches_jax(case):
    _, want, got = case
    assert abs(got["loss"] - want["loss"]) < 1e-5
    assert abs(got["interior_loss"] - want["interior_loss"]) < 1e-5


def test_interior_matches_jax(case):
    _, want, got = case
    _close(got["interior"], want["interior"], INTERIOR_BAR, 1e-7)


def test_each_estimator_matches_jax(case):
    name, want, got = case
    assert set(got["estimators"]) == set(want["estimators"])
    assert want["estimators"], name
    for est, outs in want["estimators"].items():
        _close(dict(enumerate(got["estimators"][est])), dict(enumerate(outs)),
               EST_BAR, 1e-6)


def test_totals_match_jax(case):
    _, want, got = case
    _close(got["total"], want["total"], EST_BAR, 1e-6)


def test_case_reaches_the_estimator_of_its_class(case):
    """Each twin runs the estimator its JAX class is about, and that
    estimator's term is not zero there."""
    name, want, _ = case
    expect = {"TestSilhouetteGradients": "silhouette_grad",
              "TestSilhouetteGradients_triangle": "triangle_silhouette_grad",
              "TestMirrorSilhouette": "mirror_silhouette_grad",
              "TestGlassSilhouette": "glass_silhouette_grad",
              "TestMirrorMeshSilhouette":
                  "mirror_triangle_silhouette_grad"}[name]
    assert any(np.abs(x).max() > 0 for x in want["estimators"][expect])


# ---------------------------------------------------------------------------
# direct estimator calls of the JAX classes
# ---------------------------------------------------------------------------

def test_boundary_term_zero_when_occluded_matches_jax():
    """TestSilhouetteGradients.test_boundary_term_zero_when_occluded: the
    hidden sphere's boundary term vanishes, the visible one's does not, and
    both match JAX."""
    (js, jc), (ts, tc) = _parsed(OCCLUDED_SRC)
    W = H = 24
    g = np.ones((H, W, 3), np.float32)
    kw = dict(width=W, height=H, depth=2, seed=3, n_edge=512)
    want = _jax_estimator("silhouette_grad", js, jc, g, **kw)
    d_c, d_r = tsil.silhouette_grad(ts, tc, torch.from_numpy(g), **kw)
    _close({0: d_c.numpy(), 1: d_r.numpy()}, dict(enumerate(want)), EST_BAR,
           1e-6)
    hidden = float(d_c[0].abs().max()) + abs(float(d_r[0]))
    visible = float(d_c[1].abs().max()) + abs(float(d_r[1]))
    assert visible > 0.05
    assert hidden < 0.02 * visible, (hidden, visible)


@pytest.mark.parametrize("name", ["mirror_silhouette_grad",
                                  "glass_silhouette_grad"])
def test_term_zero_without_mirror_or_dielectric(name):
    """TestMirrorSilhouette.test_mirror_term_zero_without_mirrors and
    TestGlassSilhouette.test_glass_term_zero_without_dielectric: exactly 0
    in the port."""
    (_, _), (ts, tc) = _parsed(PLAIN_SRC)
    W = H = 16
    img, _ = rtt.render_linear(ts, tc, width=W, height=H,
                               samples_per_pixel=2, depth=2, seed=1)
    d_c, d_r = getattr(tsil, name)(ts, tc, torch.ones_like(img), width=W,
                                   height=H, depth=2, seed=1, n_edge=64)
    assert float(d_c.abs().max()) == 0.0
    assert float(d_r.abs().max()) == 0.0


def test_default_world_glass_masked_pairs_are_zero():
    """A known difference: on the default world the JAX glass estimator's
    masked pairs (a sphere that is not glass in the glass slot) reach the
    sum as 0 * NaN (their |grad f| is NaN on some samples and the velocity
    divides by it unsanitized), so six of its eight rows are NaN.  The port
    builds no pair whose glass sphere is not glass: its rows are finite,
    and equal JAX's where JAX's are."""
    (js, jc), (ts, tc) = _parsed(rt.models.default_world_source())
    W, H = 32, 24
    g = (np.random.default_rng(0).standard_normal((H, W, 3)) * 1e-3
         ).astype(np.float32)
    kw = dict(width=W, height=H, depth=3, seed=5, n_edge=64)
    want = _jax_estimator("glass_silhouette_grad", js, jc, g, **kw)
    got = [x.numpy() for x in tsil.glass_silhouette_grad(
        ts, tc, torch.from_numpy(g), **kw)]
    rows = np.isfinite(want[1])
    assert 0 < rows.sum() < rows.size
    for w, x in zip(want, got):
        assert np.isfinite(x).all()
        np.testing.assert_allclose(x[rows], w[rows], rtol=0,
                                   atol=EST_BAR * np.abs(w[rows]).max()
                                   + 1e-6)


# ---------------------------------------------------------------------------
# TestEdgeSelection
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh2():
    (js, jc), (ts, tc) = rt.models.mesh_scene(subdivisions=2), \
        rtt.models.mesh_scene(subdivisions=2)
    return js, jc, ts, tc


def _pairs(tis, es):
    return np.asarray(tis).astype(np.int64) * 3 + np.asarray(es)


@pytest.mark.parametrize("n_select", [96, 512])
def test_select_edges_matches_jax(mesh2, n_select):
    """TestEdgeSelection.test_selection_prefers_in_image_edges, and the
    budget of test_selected_matches_full_sampling: the same (ti, e) pairs.
    Their order agrees except among edges whose scores differ in the last
    bits (the port solves the camera equation by Cramer's rule, JAX by LU)."""
    js, jc, ts, tc = mesh2
    W = H = 24
    g = np.ones((H, W, 3), np.float32)
    jt, je = jsil._select_edges(js, jc, jnp.asarray(g), W, H, n_select)
    tt, te = tsil._select_edges(ts, tc, torch.from_numpy(g), W, H, n_select)
    assert tt.shape == (n_select,) and te.shape == (n_select,)
    assert bool((te < 3).all()) and bool((tt < ts.num_triangles).all())
    np.testing.assert_array_equal(np.sort(_pairs(tt, te)),
                                  np.sort(_pairs(jt, je)))


def test_selected_matches_full_sampling_and_jax(mesh2):
    """TestEdgeSelection.test_selected_matches_full_sampling: the full and
    the selected estimator each match JAX's, and the selected one keeps
    the JAX test's bars against the full one."""
    js, jc, ts, tc = mesh2
    W = H = 24
    g = np.ones((H, W, 3), np.float32)
    kw = dict(width=W, height=H, depth=2, seed=7, parity_plane_sign=False,
              samples_per_edge=8)
    out = {}
    for budget in (jsil.MAX_EDGE_SAMPLES, 512):
        want = _jax_estimator("triangle_silhouette_grad", js, jc, g,
                              max_edges=budget, **kw)
        got = [x.numpy() for x in tsil.triangle_silhouette_grad(
            ts, tc, torch.from_numpy(g), max_edges=budget, **kw)]
        _close(dict(enumerate(got)), dict(enumerate(want)), EST_BAR, 1e-6)
        out[budget] = np.concatenate([x.ravel() for x in got])
    a, b = out[jsil.MAX_EDGE_SAMPLES], out[512]
    cos = float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-12))
    assert cos > 0.9, cos
    assert np.linalg.norm(b) > 0.5 * np.linalg.norm(a)


def test_mirrored_prepass_matches_jax():
    """The mirrored-edge prepass (TestMirrorMeshSilhouette's world) under a
    budget of 8 of the cube's 36 edges: the vertex gradients land on the
    same vertices as JAX's (the same edges picked) with JAX's values."""
    (js, jc), (ts, tc) = _mirror_mesh()
    W = H = 32
    g = (np.random.default_rng(3).standard_normal((H, W, 3)) * 1e-2
         ).astype(np.float32)
    kw = dict(width=W, height=H, depth=3, seed=17, parity_plane_sign=False,
              samples_per_edge=8, max_edges=8, mirror_idx=(0,))
    want = _jax_estimator("mirror_triangle_silhouette_grad", js, jc, g, **kw)
    got = [x.numpy() for x in tsil.mirror_triangle_silhouette_grad(
        ts, tc, torch.from_numpy(g), **kw)]
    for w, x in zip(want, got):
        np.testing.assert_array_equal(np.abs(x).sum(-1) > 0,
                                      np.abs(w).sum(-1) > 0)
    assert any(np.abs(w).max() > 0 for w in want)
    _close(dict(enumerate(got)), dict(enumerate(want)), EST_BAR, 1e-6)


# ---------------------------------------------------------------------------
# the silhouette fit
# ---------------------------------------------------------------------------

def test_silhouette_fit_recovers_large_offset():
    """TestSilhouetteGradients.test_silhouette_fit_recovers_large_offset,
    through the port's fit(silhouette=True, device="cpu"), with its bars."""
    w = rtt.parse_input(MIRROR_SRC)
    scene, cam = w.to_scene(), w.to_camera()
    W = H = 24
    target, _ = rtt.render_linear(scene, cam, width=W, height=H,
                                  samples_per_pixel=2, depth=2, seed=4)
    params0 = tgrad.extract_params(scene, ["sphere_center"])
    true_c = params0["sphere_center"].numpy().copy()
    params0["sphere_center"] = params0["sphere_center"] + torch.tensor(
        [[0.22, -0.18, 0.0]])
    err0 = float(np.abs(params0["sphere_center"].numpy() - true_c).max())
    result = tgrad.fit(scene, cam, target, params0, width=W, height=H,
                       samples_per_pixel=2, depth=2, steps=40,
                       learning_rate=2e-2, seed=4, silhouette=True,
                       device="cpu")
    err1 = float(np.abs(result.params["sphere_center"].numpy()
                        - true_c).max())
    assert result.losses[-1] < result.losses[0] * 0.6
    assert err1 < 0.5 * err0, (err0, err1)


def test_silhouette_train_step_sets_grads_and_steps():
    """make_silhouette_train_step: the optimiser's tensors get the
    function's grads and move; the step returns the loss before it."""
    (_, _), (ts, tc) = _parsed(MIRROR_SRC)
    kw = dict(width=12, height=12, samples_per_pixel=1, depth=2, seed=2)
    target, _ = rtt.render_linear(ts, tc, **kw)
    p = tgrad.extract_params(ts, ["sphere_center"])
    p["sphere_center"] += 0.05
    loss0, grads = tgrad.value_and_grad_with_silhouette(
        ts, tc, target, p, n_edge=64, device="cpu", **kw)
    params = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    opt = torch.optim.SGD(params.values(), lr=0.1)
    step = tgrad.make_silhouette_train_step(ts, tc, target, opt, n_edge=64,
                                            device="cpu", **kw)
    loss = step(params)
    assert float(loss) == float(loss0)
    assert torch.equal(params["sphere_center"].grad, grads["sphere_center"])
    assert torch.allclose(params["sphere_center"].detach(),
                          p["sphere_center"] - 0.1 * grads["sphere_center"])
