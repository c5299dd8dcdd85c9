"""raytracer_tpu_torch.parallel across processes: 2 gloo ranks x 2 CPU
shards each (a 4-shard mesh), spawned once for the module, rendezvous
through a file in the test's temporary directory (no TCP port).  Each rank
checks the sharded frame against its own one-device render (bitwise, equal
segments: the wavefront renderer, K1's and K3's plain versions) and the
sharded gradients (``render_linear_diff_sharded``, ``make_loss_fn(mesh=)``
with both engines) against one device, at the JAX suite's bars; the
gradients' sum over the ranks is ``_SumGrads``' all_reduce.  Without a
coordinator or torchrun's variables ``initialize_distributed`` does
nothing."""

import multiprocessing
import os

import numpy as np
import pytest
import torch

WORLD, PER_RANK = 2, 2
KW = dict(width=24, height=13, samples_per_pixel=2, depth=3, seed=4)
JOIN_S = 240


def _within(a, b) -> bool:
    """The JAX suite's gradient bar (tests/test_sharding.py:289-297)."""
    a, b = a.detach().numpy(), b.detach().numpy()
    return bool(np.abs(a - b).max() <= 1e-3 * max(np.abs(a).max(), 1e-8)
                + 1e-7)


def _grads(loss_fn, params):
    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(ps)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in ps.items()}


def _rank_main(rank, init_file, out_dir):
    """One rank: every check's outcome into ``out_dir/rank<rank>.npz``."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    import raytracer_tpu_torch as rtt
    from raytracer_tpu_torch import grad, ops, parallel
    from raytracer_tpu_torch.ops import diff

    parallel.initialize_distributed("file://" + init_file, WORLD, rank,
                                    device="cpu")
    parallel.initialize_distributed("file://" + init_file, WORLD, rank,
                                    device="cpu")        # idempotent
    mesh = parallel.make_mesh(WORLD * PER_RANK, device="cpu")
    out = dict(multi_host=parallel.is_multi_host(), size=mesh.size,
               shards=[s.index for s in mesh.local_shards()],
               backend=dist.get_backend())

    w = rtt.models.default_world()
    scene, cam = w.to_scene(), w.to_camera()
    one, one_s = rtt.render_linear(scene, cam, **KW)
    img, segs = parallel.render_linear_sharded(scene, cam, mesh=mesh, **KW)
    out["wavefront"] = bool(torch.equal(one, img)) and one_s == segs
    one, one_s = ops.render_linear_fast(scene, cam, device="cpu",
                                        engine="torch", **KW)
    img, segs = parallel.render_linear_sharded_fast(scene, cam, mesh=mesh,
                                                    engine="torch", **KW)
    out["k1"] = bool(torch.equal(one, img)) and one_s == segs
    ms, mc = rtt.models.mesh_scene(2)
    bkw = dict(KW, width=48, height=37)
    one, one_s = ops.render_linear_fast(ms, mc, device="cpu",
                                        engine="torch_binned", **bkw)
    img, segs = parallel.render_linear_sharded_fast(
        ms, mc, mesh=mesh, engine="torch_binned", **bkw)
    out["k3"] = bool(torch.equal(one, img)) and one_s == segs

    # render_linear_diff_sharded: sum(img^2) in the sphere centres, radii
    # and the material colours
    def value_and_grad(render):
        c = scene.sphere_center.clone().requires_grad_(True)
        r = scene.sphere_radius.clone().requires_grad_(True)
        col = scene.materials.color.clone().requires_grad_(True)
        import dataclasses
        s = dataclasses.replace(
            scene, sphere_center=c, sphere_radius=r,
            materials=dataclasses.replace(scene.materials, color=col))
        img = render(s)
        v = torch.sum(img * img)
        v.backward()
        return v.detach(), (c.grad, r.grad, col.grad)

    v1, g1 = value_and_grad(lambda s: diff.render_linear_diff(s, cam, **KW))
    v2, g2 = value_and_grad(lambda s: parallel.render_linear_diff_sharded(
        s, cam, mesh=mesh, **KW))
    out["diff_value"] = bool(abs(v1 - v2) < 1e-4 * max(abs(float(v1)), 1.0))
    out["diff_grads"] = all(_within(a, b) for a, b in zip(g1, g2))

    # make_loss_fn(mesh=) against one device, both engines
    target, _ = rtt.render_linear(scene, cam, **KW)
    params = grad.extract_params(scene, ["sphere_center", "mat_color"])
    rng = np.random.default_rng(3)
    params = {k: v + torch.from_numpy(rng.uniform(-0.02, 0.02, v.shape)
                                      .astype(np.float32))
              for k, v in params.items()}
    for engine in ("pallas", "xla"):
        l1, p1 = _grads(grad.make_loss_fn(scene, cam, target, engine=engine,
                                          device="cpu", **KW), params)
        l2, p2 = _grads(grad.make_loss_fn(scene, cam, target, engine=engine,
                                          mesh=mesh, **KW), params)
        out[f"loss_{engine}"] = bool(abs(l1 - l2) < 1e-4 * abs(float(l1)))
        out[f"grads_{engine}"] = all(_within(p1[k], p2[k]) for k in params)
    dist.barrier()
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, str(tmp / "rendezvous"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=JOIN_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def test_ranks_form_a_four_shard_mesh(ranks):
    for r, out in enumerate(ranks):
        assert bool(out["multi_host"]) and str(out["backend"]) == "gloo"
        assert int(out["size"]) == WORLD * PER_RANK
        assert list(out["shards"]) == [r * PER_RANK + j
                                       for j in range(PER_RANK)]


@pytest.mark.parametrize("path", ["wavefront", "k1", "k3"])
def test_sharded_image_is_the_one_device_image(ranks, path):
    assert all(bool(out[path]) for out in ranks)


def test_diff_sharded_value_and_grads_match_one_device(ranks):
    assert all(bool(out["diff_value"]) and bool(out["diff_grads"])
               for out in ranks)


@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_make_loss_fn_mesh_grads_match_one_device(ranks, engine):
    assert all(bool(out[f"loss_{engine}"]) and bool(out[f"grads_{engine}"])
               for out in ranks)


def test_initialize_without_a_cluster_is_a_no_op(monkeypatch):
    import torch.distributed as dist
    from raytracer_tpu_torch import parallel
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    parallel.initialize_distributed(device="cpu")
    assert not dist.is_initialized() and not parallel.is_multi_host()
    assert parallel.make_mesh(device="cpu").group is None
    assert parallel.host_local_mesh(device="cpu").size == 1
