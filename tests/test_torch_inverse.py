"""The port's inverse rendering (grad.params, grad.finite_diff,
grad.inverse, utils.checkpoint), held to the bars of the JAX package's own
tests (tests/test_grad.py): AD against central differences on the albedo
case (cosine > 0.999), albedo recovery by ``fit``, checkpoint resume, a
few optimiser steps through the kernel path, and the parameter dicts
against the JAX package's."""

import numpy as np
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import grad as jgrad
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import grad as tgrad
from raytracer_tpu_torch.utils import checkpoint


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def test_params_match_jax_and_round_trip():
    tscene = rtt.models.default_world().to_scene()
    jscene = rt.models.default_world().to_scene()
    fields = list(tgrad.PARAM_FIELDS)
    assert fields == list(jgrad.PARAM_FIELDS)
    tp = tgrad.extract_params(tscene, fields)
    jp = jgrad.extract_params(jscene, fields)
    for k in fields:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    moved = tgrad.params_from_arrays(
        {k: np.asarray(v) * 1.5 for k, v in jp.items()}, "cpu")
    s2 = tgrad.apply_params(tscene, moved)
    assert s2.sphere_center is moved["sphere_center"]
    assert s2.materials.fuzz is moved["mat_fuzz"]
    assert s2.sphere_mat is tscene.sphere_mat
    # extracted params are copies: updating them leaves the scene alone
    tp["mat_color"].mul_(0.0)
    assert tscene.materials.color.any()
    with pytest.raises(ValueError, match="unknown param"):
        tgrad.extract_params(tscene, ["sphere_colour"])


def test_albedo_grads_match_fd_unmasked():
    """test_albedo_grads_match_fd_unmasked: default world 16x16, 2 spp,
    depth 3, seed 7, albedo x0.8."""
    w = rtt.models.default_world()
    scene, cam = w.to_scene(), w.to_camera()
    kw = dict(width=16, height=16, samples_per_pixel=2, depth=3, seed=7)
    target, _ = rtt.render_linear(scene, cam, **kw)
    loss = tgrad.make_loss_fn(scene, cam, target, device="cpu", **kw)
    params = tgrad.extract_params(scene, ["mat_color"])
    params["mat_color"] = params["mat_color"] * 0.8
    p = {"mat_color": params["mat_color"].clone().requires_grad_(True)}
    loss(p).backward()
    ad = p["mat_color"].grad.numpy()
    fd = tgrad.finite_diff_grad(loss, params, eps=1e-3)
    assert np.isfinite(ad).all()
    assert _cos(ad, fd["mat_color"]) > 0.999


def test_fit_recovers_albedo():
    """test_fit_recovers_albedo: sphere_and_ground 16x16, 2 spp, depth 2,
    60 Adam steps at 5e-2 from half the albedo."""
    w = rtt.models.sphere_and_ground()
    scene, cam = w.to_scene(), w.to_camera()
    target, _ = rtt.render_linear(scene, cam, width=16, height=16,
                                  samples_per_pixel=2, depth=2, seed=2)
    params0 = tgrad.extract_params(scene, ["mat_color"])
    true_color = params0["mat_color"].numpy().copy()
    params0["mat_color"] = params0["mat_color"] * 0.5
    start = params0["mat_color"].clone()
    result = tgrad.fit(scene, cam, target, params0, width=16, height=16,
                       samples_per_pixel=2, depth=2, steps=60,
                       learning_rate=5e-2, seed=2, device="cpu")
    assert result.losses[-1] < result.losses[0] * 0.05
    assert np.abs(result.params["mat_color"].numpy() - true_color).max() \
        < 0.12
    assert torch.equal(params0["mat_color"], start)   # inputs untouched


def test_checkpoint_resume(tmp_path):
    """test_checkpoint_resume: 10 steps with a checkpoint every 5, then a
    resumed fit to 15 runs only the last 5 -- and lands where an unbroken
    15-step fit lands."""
    w = rtt.models.sphere_and_ground()
    scene, cam = w.to_scene(), w.to_camera()
    target, _ = rtt.render_linear(scene, cam, width=8, height=8,
                                  samples_per_pixel=1, depth=2, seed=9)
    params0 = tgrad.extract_params(scene, ["mat_color"])
    params0["mat_color"] = params0["mat_color"] * 0.6
    kw = dict(width=8, height=8, samples_per_pixel=1, depth=2, seed=9,
              device="cpu")
    ck = str(tmp_path / "ck.npz")
    tgrad.fit(scene, cam, target, params0, steps=10, checkpoint_path=ck,
              checkpoint_every=5, **kw)
    r2 = tgrad.fit(scene, cam, target, params0, steps=15, checkpoint_path=ck,
                   checkpoint_every=5, **kw)
    assert r2.steps_run == 5 and len(r2.losses) == 15
    whole = tgrad.fit(scene, cam, target, params0, steps=15, **kw)
    np.testing.assert_allclose(r2.losses, whole.losses, rtol=1e-6)
    np.testing.assert_allclose(r2.params["mat_color"].numpy(),
                               whole.params["mat_color"].numpy(), rtol=1e-6)


def test_checkpoint_file_round_trip(tmp_path):
    p = {"sphere_center": torch.randn(3, 3, requires_grad=True)}
    opt = torch.optim.Adam(p.values(), lr=3e-2)
    p["sphere_center"].sum().backward()
    opt.step()
    path = str(tmp_path / "sub" / "c.npz")
    checkpoint.save(path, p, opt, 7, [1.0, 0.5])
    params, state, step, losses = checkpoint.load(path)
    assert step == 7 and losses == [1.0, 0.5]
    np.testing.assert_array_equal(params["sphere_center"],
                                  p["sphere_center"].detach().numpy())
    want = opt.state_dict()
    assert state["param_groups"][0]["lr"] == 3e-2
    assert tuple(state["param_groups"][0]["betas"]) == (0.9, 0.999)
    for k in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(state["state"][0][k], want["state"][0][k])
    opt2 = torch.optim.Adam([torch.zeros(3, 3, requires_grad=True)])
    opt2.load_state_dict(state)
    assert checkpoint.load(str(tmp_path / "missing.npz")) is None
    assert [f.name for f in (tmp_path / "sub").iterdir()] == ["c.npz"]


def test_train_steps_through_kernel_path_reduce_loss():
    """test_fit_loop_through_kernel_forward: sphere_and_ground 12x12,
    1 spp, depth 2, Adam 1e-2, five steps through K1 + K5 (their plain
    versions here)."""
    w = rtt.models.sphere_and_ground()
    scene, cam = w.to_scene(), w.to_camera()
    kw = dict(width=12, height=12, samples_per_pixel=1, depth=2, seed=5)
    target, _ = rtt.render_linear(scene, cam, **kw)
    params = tgrad.extract_params(scene, ["mat_color"])
    params["mat_color"] = (params["mat_color"] * 0.7).requires_grad_(True)
    loss = tgrad.make_loss_fn(scene, cam, target, engine="pallas",
                              device="cpu", **kw)
    step = tgrad.make_train_step(loss, torch.optim.Adam(params.values(),
                                                        lr=1e-2))
    losses = [float(step(params)) for _ in range(5)]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("call", ["fit_silhouette_mesh", "fit_mesh",
                                  "loss_mesh"])
def test_unported_options_raise(call):
    w = rtt.models.sphere_and_ground()
    scene, cam = w.to_scene(), w.to_camera()
    kw = dict(width=4, height=4, samples_per_pixel=1, depth=1, device="cpu")
    target = torch.zeros(4, 4, 3)
    params = tgrad.extract_params(scene, ["mat_color"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "fit_silhouette_mesh":
            # the silhouette fit is single-device, as in the JAX package
            tgrad.fit(scene, cam, target, params, silhouette=True,
                      mesh=object(), **kw)
        elif call == "fit_mesh":
            tgrad.fit(scene, cam, target, params, mesh=object(), **kw)
        else:
            tgrad.make_loss_fn(scene, cam, target, mesh=object(), **kw)


@pytest.mark.parametrize("call", ["make_loss_fn", "fit",
                                  "make_silhouette_train_step",
                                  "value_and_grad_with_silhouette"])
def test_default_device_is_the_card_and_raises_without_one(call,
                                                           monkeypatch):
    """make_loss_fn, fit and the silhouette entry points run on
    device="cuda" unless told otherwise: with no GPU they raise, naming
    device="cpu", and never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = rtt.models.sphere_and_ground()
    scene, cam = w.to_scene(), w.to_camera()
    kw = dict(width=4, height=4, samples_per_pixel=1, depth=1)
    target = torch.zeros(4, 4, 3)
    params = tgrad.extract_params(scene, ["mat_color"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if call == "fit":
            tgrad.fit(scene, cam, target, params, steps=1, **kw)
        elif call == "make_silhouette_train_step":
            tgrad.make_silhouette_train_step(
                scene, cam, target, torch.optim.Adam(params.values()), **kw)
        elif call == "value_and_grad_with_silhouette":
            tgrad.value_and_grad_with_silhouette(scene, cam, target, params,
                                                 **kw)
        else:
            tgrad.make_loss_fn(scene, cam, target, engine="auto", **kw)
