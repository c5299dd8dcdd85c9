"""raytracer_tpu_torch.parallel on 8 CPU shards (``make_mesh(8,
device="cpu")``): twins of tests/test_sharding.py.  The sharded images of
the wavefront renderer and of the plain versions of K1, K3 and K4 are the
one-device images bit for bit with equal segment counts (padded pixels,
rows that the shard count does not divide, 37-row frames for K3's 16-row
tiles), sharded gradients are the one-device gradients within the JAX
suite's bars, and the sharded wavefront render and K3 on tile rows agree
with the JAX package within test_torch_wavefront.py's twin bar."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import parallel as jparallel
from raytracer_tpu.ops.pallas import wavefront as jwf
from raytracer_tpu.ops.pallas import wavefront_binned as jbn
from raytracer_tpu.ops.pallas import wavefront_sorted as jso
from raytracer_tpu.ops.pallas.wavefront_stream import sorted_top_order
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import grad, ops, parallel
from raytracer_tpu_torch.ops import diff, tables
from raytracer_tpu_torch.ops.cuda import wavefront as wfc
from raytracer_tpu_torch.ops.cuda import wavefront_binned as wb
from raytracer_tpu_torch.parallel import sharding

ATOL = 1e-5      # tests/test_torch_wavefront.py's twin bar


@pytest.fixture(scope="module")
def mesh8():
    return parallel.make_mesh(8, device="cpu")


@pytest.fixture(scope="module")
def world():
    w = rtt.models.default_world()
    return w.to_scene(), w.to_camera()


def _fast(scene, cam, **kw):
    return ops.render_linear_fast(scene, cam, device="cpu", **kw)


class TestMesh:
    def test_cpu_mesh_layout(self, mesh8):
        assert mesh8.size == 8 and mesh8.shape == {parallel.RAYS_AXIS: 8}
        assert mesh8.group is None and mesh8.world_size == 1
        assert [s.index for s in mesh8.local_shards()] == list(range(8))
        assert parallel.replicated(mesh8) == (torch.device("cpu"),)
        assert [s for _, s in parallel.ray_sharded(mesh8)][3] == \
            slice(3, None, 8)
        assert parallel.pad_to_multiple(13, 8) == 16

    def test_cuda_mesh_needs_a_gpu_and_a_count_it_has(self):
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="visible"):
                parallel.make_mesh(torch.cuda.device_count() + 1)
        else:
            with pytest.raises(RuntimeError, match="NVIDIA GPU"):
                parallel.make_mesh(1)


class TestShardedRender:
    def test_bitwise_equal_to_single_device(self, world, mesh8):
        scene, cam = world
        kw = dict(width=48, height=24, samples_per_pixel=4, depth=4)
        img1, seg1 = rtt.render_linear(scene, cam, **kw)
        img2, seg2 = parallel.render_linear_sharded(scene, cam, mesh=mesh8,
                                                    **kw)
        assert torch.equal(img1, img2) and seg1 == seg2

    def test_non_divisible_pixel_count_padded(self, world, mesh8):
        scene, cam = world
        # 35 * 13 = 455 pixels, not a multiple of 8
        kw = dict(width=35, height=13, samples_per_pixel=2, depth=3)
        img1, seg1 = rtt.render_linear(scene, cam, **kw)
        img2, seg2 = parallel.render_linear_sharded(scene, cam, mesh=mesh8,
                                                    **kw)
        assert torch.equal(img1, img2) and seg1 == seg2

    def test_output_actually_sharded(self, world, mesh8, monkeypatch):
        scene, cam = world
        sizes = []
        real = sharding.accumulate_samples

        def spy(scene, camera, rows, cols, *a, **k):
            sizes.append(rows.shape[0])
            return real(scene, camera, rows, cols, *a, **k)

        monkeypatch.setattr(sharding, "accumulate_samples", spy)
        img, _ = parallel.render_linear_sharded(
            scene, cam, mesh=mesh8, width=32, height=16,
            samples_per_pixel=1, depth=2)
        assert img.shape == (16, 32, 3) and sizes == [64] * 8

    def test_subset_mesh(self, world):
        scene, cam = world
        mesh2 = parallel.make_mesh(2, device="cpu")
        kw = dict(width=16, height=8, samples_per_pixel=2, depth=2)
        img1, _ = rtt.render_linear(scene, cam, **kw)
        img2, _ = parallel.render_linear_sharded(scene, cam, mesh=mesh2,
                                                 **kw)
        assert torch.equal(img1, img2)

    def test_ray_trace_sharded_u8(self, world, mesh8):
        scene, cam = world
        opts = rtt.Options(samples_per_pixel=2, max_ray_bounces=3,
                           device="cpu")
        fb, segs = parallel.ray_trace_sharded(scene, cam, 32, 16, opts,
                                              mesh=mesh8)
        fb1, segs1 = rtt.ray_trace(scene, cam, 32, 16, opts)
        assert np.array_equal(fb, fb1) and segs == segs1 > 0


class TestShardedPallas:
    """The kernels' plain versions row- or tile-row-sharded: the gathered
    image is the one-device plain render bit for bit, segments equal."""

    def test_sharded_kernel_bitwise_equal(self, world, mesh8):
        scene, cam = world
        kw = dict(width=64, height=48, samples_per_pixel=2, depth=4, seed=3)
        ref, seg_ref = _fast(scene, cam, engine="torch", **kw)
        out, seg = parallel.render_linear_sharded_fast(
            scene, cam, mesh=mesh8, engine="torch", **kw)
        assert torch.equal(ref, out) and seg_ref == seg

    def test_sharded_kernel_non_divisible_rows(self, world, mesh8):
        # 13 rows over 8 shards: rows_per=2, the last shards' second rows
        # are dead lanes
        scene, cam = world
        kw = dict(width=32, height=13, samples_per_pixel=2, depth=3, seed=1)
        ref, seg_ref = _fast(scene, cam, engine="torch", **kw)
        out, seg = parallel.render_linear_sharded_fast(
            scene, cam, mesh=mesh8, **kw)      # "auto" on the CPU: torch
        assert torch.equal(ref, out) and seg_ref == seg

    def test_sharded_binned_engine_bitwise_equal(self, mesh8):
        scene, cam = rtt.models.mesh_scene(2)
        kw = dict(width=64, height=48, samples_per_pixel=2, depth=3)
        ref, seg_ref = _fast(scene, cam, engine="torch_binned", **kw)
        out, seg = parallel.render_linear_sharded_fast(
            scene, cam, mesh=mesh8, engine="torch_binned", **kw)
        assert torch.equal(ref, out) and seg_ref == seg

    def test_sharded_binned_odd_height(self, mesh8):
        # 37 rows, 2 tile rows of 32 over 8 shards: most shards hold no row
        # of the image; a spp of 3 renders as parts 2 + 1; at 32 spp the
        # tiles are 8 rows, 5 over 2 shards: 3 tile rows each, one dead
        scene, cam = rtt.models.mesh_scene(2)
        mesh2 = parallel.make_mesh(2, device="cpu")
        for mesh, width, spp in ((mesh8, 48, 2), (mesh8, 48, 3),
                                 (mesh2, 32, 32)):
            kw = dict(width=width, height=37, samples_per_pixel=spp,
                      depth=2)
            ref, seg_ref = _fast(scene, cam, engine="torch_binned", **kw)
            out, seg = parallel.render_linear_sharded_fast(
                scene, cam, mesh=mesh, engine="torch_binned", **kw)
            assert torch.equal(ref, out) and seg_ref == seg, spp

    def test_sharded_stream_and_sorted_engines(self, mesh8):
        # the sorted engine shards as the binned one (binned_spp_ok) or
        # the streamed one; both are the one-device frame
        scene, cam = rtt.models.mesh_scene(2)
        kw = dict(width=40, height=13, samples_per_pixel=2, depth=3)
        ref, seg_ref = _fast(scene, cam, engine="torch_stream", **kw)
        for engine in ("torch_stream", "torch_sorted"):
            out, seg = parallel.render_linear_sharded_fast(
                scene, cam, mesh=mesh8, engine=engine, **kw)
            assert torch.equal(ref, out) and seg_ref == seg, engine
        with pytest.raises(ValueError, match="parity_plane_sign"):
            parallel.render_linear_sharded_fast(
                scene, cam, mesh=mesh8, engine="torch_stream",
                parity_plane_sign=True, **kw)

    def test_row_band_render_matches_full(self, world):
        # banded kernel render (shard_rows / row_offset) == the matching
        # rows of a full render: the property the sharded path rests on
        scene, cam = world
        sph, tri, scl, tcl = ops.scene_tables(scene, True, "cpu")
        cv = tables.camera_vec(cam)
        kw = dict(width=32, height=24, samples_per_pixel=2, depth=3,
                  sph_clusters=scl, tri_clusters=tcl)
        full, _ = wfc.render_linear_ref(sph, tri, cv, **kw)
        band, _ = wfc.render_linear_ref(sph, tri, cv, **kw, shard_rows=8,
                                        row_offset=10)
        assert torch.equal(full[10:18], band)

    def test_xla_fallback_engine(self, world, mesh8):
        scene, cam = world
        kw = dict(width=16, height=8, samples_per_pixel=2, depth=2)
        img1, seg1 = rtt.render_linear(scene, cam, **kw)
        img2, seg2 = parallel.render_linear_sharded_fast(
            scene, cam, mesh=mesh8, engine="xla", **kw)
        assert torch.equal(img1, img2) and seg1 == seg2


class TestPackCache:
    def test_scene_tables_cached_on_identity(self):
        scene = rtt.models.default_world().to_scene()
        t1 = ops.scene_tables(scene, True, "cpu")
        n = ops.pack_events
        t2 = ops.scene_tables(scene, True, "cpu")
        assert ops.pack_events == n          # no repack
        assert t1[0] is t2[0] and t1[1] is t2[1]
        scene2 = rtt.models.default_world().to_scene()   # new object
        ops.scene_tables(scene2, True, "cpu")
        assert ops.pack_events == n + 1

    def test_second_sharded_frame_does_not_repack(self, mesh8):
        scene, cam = rtt.models.mesh_scene(2)
        kw = dict(width=16, height=16, samples_per_pixel=1, depth=2)
        for engine in ("torch", "torch_binned", "torch_stream"):
            parallel.render_linear_sharded_fast(scene, cam, mesh=mesh8,
                                                engine=engine, **kw)
            n = ops.pack_events
            parallel.render_linear_sharded_fast(scene, cam, mesh=mesh8,
                                                engine=engine, **kw)
            assert ops.pack_events == n, engine

    def test_device_copy_made_once_per_scene(self):
        # a shard on another device than the scene's gets one copy, kept
        # while the scene lives (the "meta" device stands in for a card)
        meta = torch.device("meta")

        def copy_twice():
            scene = rtt.models.default_world().to_scene()
            a = sharding._on(scene, meta)
            assert a is not scene and a.device == meta
            assert sharding._on(scene, meta) is a
            assert sharding._on(scene, torch.device("cpu")) is scene

        copy_twice()
        other = rtt.models.default_world().to_scene()
        sharding._on(other, meta)
        # the dead scene's copy went when the next copy was made
        assert [ref() for ref, _ in sharding._DEVICE_COPIES.values()] == \
            [other]


def _perturbed(scene, fields, rng):
    params = grad.extract_params(scene, fields)
    for k, v in params.items():
        params[k] = v + torch.from_numpy(
            rng.uniform(-0.02, 0.02, v.shape).astype(np.float32))
    return params


def _loss_grads(loss_fn, params):
    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(ps)
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in ps.items()}


class TestShardedGradients:
    def test_sharded_grad_matches_single_device(self, mesh8):
        w = rtt.models.sphere_and_ground()
        scene, cam = w.to_scene(), w.to_camera()
        kw = dict(width=24, height=16, samples_per_pixel=2, depth=2, seed=3)
        target, _ = rtt.render_linear(scene, cam, **kw)
        params = _perturbed(scene, ["sphere_center", "mat_color"],
                            np.random.default_rng(0))
        l1, g1 = _loss_grads(grad.make_loss_fn(scene, cam, target,
                                               device="cpu", **kw), params)
        l2, g2 = _loss_grads(grad.make_loss_fn(scene, cam, target,
                                               mesh=mesh8, **kw), params)
        assert abs(l1 - l2) <= 1e-6 * abs(l1)
        for k in params:
            np.testing.assert_allclose(g1[k].numpy(), g2[k].numpy(),
                                       rtol=1e-5, atol=1e-8)

    def test_sharded_train_step_runs(self, mesh8):
        # the whole sharded training step: forward, backward, the gradient
        # sum over shards, Adam
        w = rtt.models.sphere_and_ground()
        scene, cam = w.to_scene(), w.to_camera()
        kw = dict(width=16, height=16, samples_per_pixel=1, depth=2, seed=0)
        target, _ = rtt.render_linear(scene, cam, **kw)
        p0 = grad.extract_params(scene, ["mat_color"])
        r = grad.fit(scene, cam, target, {"mat_color": p0["mat_color"] * 0.7},
                     steps=2, learning_rate=1e-2, mesh=mesh8, **kw)
        assert np.isfinite(r.losses).all() and r.losses[1] <= r.losses[0]
        with pytest.raises(ValueError, match="single-device"):
            grad.fit(scene, cam, target, p0, steps=1, mesh=mesh8,
                     silhouette=True, **kw)


class TestShardedDiff:
    """Sharded K1 + K5 (and K2 + K5s) forward and backward against one
    device, at the JAX suite's bars."""

    W, H, SPP, D = 32, 24, 2, 3

    @pytest.mark.parametrize("walk", ["k1_k5", "k2_k5s"])
    def test_grads_match_single_device(self, mesh8, monkeypatch, walk):
        if walk == "k1_k5":
            scene = rtt.models.default_world().to_scene()
            cam = rtt.models.default_world().to_camera()
            cull, parity = None, True
            fields = ("sphere_center", "sphere_radius")
        else:
            scene, cam = rtt.models.mesh_scene(2)
            cull, parity = diff.build_tri_cull(scene, 16), False
            monkeypatch.setattr(diff, "_needs_stream", lambda s: True)
            fields = ("tri_v0",)
        kw = dict(width=self.W, height=self.H, samples_per_pixel=self.SPP,
                  depth=self.D, seed=5, parity_plane_sign=parity,
                  tri_cull=cull)

        def value_and_grad(render):
            leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                      for f in fields}
            color = scene.materials.color.clone().requires_grad_(True)
            s = dataclasses.replace(
                scene, **leaves,
                materials=dataclasses.replace(scene.materials, color=color))
            img = render(s)
            v = torch.sum(img * img)
            v.backward()
            return float(v.detach()), {**{f: t.grad
                                          for f, t in leaves.items()},
                              "color": color.grad}

        v1, g1 = value_and_grad(
            lambda s: diff.render_linear_diff(s, cam, **kw))
        v2, g2 = value_and_grad(
            lambda s: parallel.render_linear_diff_sharded(s, cam, mesh=mesh8,
                                                          **kw))
        assert abs(v1 - v2) < 1e-4 * max(abs(v1), 1.0)
        for name in g1:
            a, b = g1[name].numpy(), g2[name].numpy()
            scale = max(np.abs(a).max(), 1e-8)
            assert np.abs(a - b).max() <= 1e-3 * scale + 1e-7, name

    def test_sharded_fit_step_through_kernel(self, world, mesh8):
        # Adam steps of the sharded kernel loss decrease it
        scene, cam = world
        kw = dict(width=16, height=12, samples_per_pixel=1, depth=2, seed=3)
        target, _ = rtt.render_linear(scene, cam, **kw)
        params = grad.extract_params(scene, ["mat_color"])
        params["mat_color"] = (params["mat_color"] * 0.7).requires_grad_(True)
        loss = grad.make_loss_fn(scene, cam, target, mesh=mesh8,
                                 engine="pallas", **kw)
        opt = torch.optim.Adam([params["mat_color"]], lr=5e-2)
        step = grad.make_train_step(loss, opt)
        l0 = float(step(params))
        for _ in range(3):
            l1 = float(step(params))
        assert l1 < l0


class TestAgainstJax:
    def test_wavefront_sharded_matches_jax(self, mesh8):
        kw = dict(width=24, height=13, samples_per_pixel=2, depth=3, seed=4)
        tw, jw = rtt.models.default_world(), rt.models.default_world()
        got, segs = parallel.render_linear_sharded(
            tw.to_scene(), tw.to_camera(), mesh=mesh8, **kw)
        want, wsegs = jparallel.render_linear_sharded(
            jw.to_scene(), jw.to_camera(), mesh=jparallel.make_mesh(8),
            **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        assert segs == int(wsegs)

    def test_binned_tile_rows_match_jax(self):
        # the odd-height shape of tests/test_sharding.py: 2 tile rows of
        # 32, the second of two shards (tile row 1)
        kw = dict(width=48, height=37, samples_per_pixel=2, depth=2, seed=0,
                  tile_row_offset=1, tile_row_stride=2, shard_tile_rows=1)
        ts, tc = rtt.models.mesh_scene(2)
        js, jc = rt.models.mesh_scene(2)
        t = [torch.from_numpy(np.ascontiguousarray(a))
             for a in tables.build_tri_sorted_tables(ts)]
        o, k = sorted_top_order(t[4].numpy(), tc.origin.numpy())
        got, segs = wb.render_linear_binned(
            torch.from_numpy(tables.pack_spheres(ts)), *t,
            tables.camera_vec(tc), top_order=torch.from_numpy(o),
            top_keys=torch.from_numpy(k), plain=True, **kw)
        jt = [jnp.asarray(a) for a in jso.build_tri_sorted_tables(js)]
        want, wsegs = jbn.render_linear_pallas_binned(
            jnp.asarray(jwf.pack_spheres(js)), *jt, jwf.camera_vec(jc),
            interpret=True, top_order=jnp.asarray(o), top_keys=jnp.asarray(k),
            ray_regroup_bounces=kw["depth"] - 1, **kw)
        want = np.asarray(want)
        assert got.shape == want.shape == (32, 48, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
        assert segs == int(wsegs) and segs > 0
