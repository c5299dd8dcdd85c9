"""The sorted engine (raytracer_tpu_torch.ops.cuda.wavefront_sorted) on the
CPU, mirroring tests/test_pallas_sorted.py.  The Morton helpers and the
sort keys equal the JAX package's element for element; the plain K6 frame
(every bounce through sorted_bounce_ref) against
``render_linear_pallas_sorted`` in interpret mode, bar: equal segment
counts and max|diff| <= 1e-4 with the median <= 1e-6 (the looser max
allows XLA:CPU's multiply-add contraction, as tests/test_torch_binned.py).
Then, bit for bit and port-only: node_exit changes nothing, the frame
equals K1's and K4's plain versions (samples summed in sample order), a
depth-0 frame is black, the wrapper runs the plain version on CPU tensors,
bad inputs raise; and the dispatch table against the JAX package's,
decided for a CUDA device without one."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import ops as jops
from raytracer_tpu.ops.pallas import wavefront as jwf
from raytracer_tpu.ops.pallas import wavefront_sorted as jso
from raytracer_tpu.ops.pallas.wavefront_stream import sorted_top_order
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import api, ops
from raytracer_tpu_torch.ops import tables
from raytracer_tpu_torch.ops.cuda import wavefront as wfc
from raytracer_tpu_torch.ops.cuda import wavefront_sorted as wso
from raytracer_tpu_torch.ops.cuda import wavefront_stream as wst

MAX_ERR, MEDIAN_ERR = 1e-4, 1e-6


# ---------------------------------------------------------------------------
# Morton helpers and sort keys
# ---------------------------------------------------------------------------

def test_morton_helpers_match_jax():
    r = np.random.default_rng(11)
    x = np.concatenate([np.arange(2048), r.integers(0, 1 << 31, 4096)])
    x = x.astype(np.int32)
    np.testing.assert_array_equal(
        wso.part1by2(torch.from_numpy(x)).numpy(),
        np.asarray(jso._part1by2(jnp.asarray(x))))
    np.testing.assert_array_equal(
        wso.compact1by1(torch.from_numpy(x)).numpy(),
        np.asarray(jso._compact1by1(jnp.asarray(x))))


def _random_state(seed, n=4096):
    """Seeded ray states: origins inside and outside the key box, unit
    directions with exact +-1 components among them, dead rays."""
    r = np.random.default_rng(seed)
    st = r.uniform(-3.0, 3.0, (jso.STATE_PLANES, n)).astype(np.float32)
    d = r.normal(size=(3, n))
    st[3:6] = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    axes = np.eye(3, dtype=np.float32)
    for k in range(6):
        st[3:6, k] = axes[k % 3] * (1.0 if k < 3 else -1.0)
    st[jso._ST_ALIVE] = (r.uniform(size=n) < 0.7).astype(np.float32)
    return st


@pytest.mark.parametrize("seed,box", [
    (1, ([-1.0, -0.5, -2.0], [1.5, 1.0, 0.0])),
    (2, ([-4.0, -4.0, -4.0], [4.0, 4.0, 4.0])),
    (3, ([0.25, -1.0, 1.0], [0.25, 2.0, 1.0]))])   # flat axes: span 1e-6
def test_sort_keys_match_jax(seed, box):
    st = _random_state(seed)
    lo, hi = (np.asarray(b, np.float32) for b in box)
    want = np.asarray(jso._sort_keys(jnp.asarray(st), jnp.asarray(lo),
                                     jnp.asarray(hi)))
    got = wso.sort_keys(torch.from_numpy(st), torch.from_numpy(lo),
                        torch.from_numpy(hi))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dead = st[jso._ST_ALIVE] < 0.5
    assert (got.numpy()[dead] == wso.KEY_DEAD).all()
    assert (got.numpy()[~dead] < wso.KEY_DEAD).all()


def test_ray_layout():
    assert wso.ray_layout(64, 48, 2) == (64, 64 * 64 * 2)
    assert wso.ray_layout(37, 21, 1) == (64, 64 * 64)
    assert wso.ray_layout(1, 1, 3) == (2, 128)
    assert wso.ray_layout(1024, 1024, 32) == (1024, 1 << 25)
    with pytest.raises(ValueError):
        wso.ray_layout(32768, 32768, 4)
    with pytest.raises(ValueError):
        wso.ray_layout(8, 8, 0)


# ---------------------------------------------------------------------------
# The frame against the JAX package
# ---------------------------------------------------------------------------

def _scenes(name):
    if name == "default_world":
        return (rtt.models.default_world().to_scene(),
                rtt.models.default_world().to_camera(),
                rt.models.default_world().to_scene(),
                rt.models.default_world().to_camera())
    sub = int(name[-1])
    return (*rtt.models.mesh_scene(sub), *rt.models.mesh_scene(sub))


def _port_args(scene, cam):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in tables.build_tri_sorted_tables(scene)]
    o, k = sorted_top_order(t[4].numpy(), cam.origin.numpy())
    return ((torch.from_numpy(tables.pack_spheres(scene)), *t,
             tables.camera_vec(cam)),
            dict(top_order=torch.from_numpy(o), top_keys=torch.from_numpy(k)))


def _port(scene, cam, plain=True, **kw):
    args, extra = _port_args(scene, cam)
    return wso.render_linear_sorted(*args, plain=plain, **extra, **kw)


def _jax(scene, cam, **kw):
    t = [jnp.asarray(a) for a in jso.build_tri_sorted_tables(scene)]
    o, k = sorted_top_order(np.asarray(t[4]), np.asarray(cam.origin))
    return jso.render_linear_pallas_sorted(
        jnp.asarray(jwf.pack_spheres(scene)), *t, jwf.camera_vec(cam),
        interpret=True, top_order=jnp.asarray(o), top_keys=jnp.asarray(k),
        **kw)


CASES = {
    # name: (scene, W, H, spp, depth)
    "mesh2_64x48_2spp_depth4": ("mesh_scene2", 64, 48, 2, 4),
    "mesh3_32x24_2spp_depth3": ("mesh_scene3", 32, 24, 2, 3),
    "mesh2_37x21_1spp_depth1": ("mesh_scene2", 37, 21, 1, 1),
    "sphere_only_24x16": ("default_world", 24, 16, 2, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_sorted_interpret(case):
    name, W, H, spp, depth = CASES[case]
    ts, tc, js, jc = _scenes(name)
    kw = dict(width=W, height=H, samples_per_pixel=spp, depth=depth, seed=4)
    got, segs = _port(ts, tc, **kw)
    want, wsegs = _jax(js, jc, **kw)
    want = np.asarray(want)
    assert got.shape == want.shape == (H, W, 3)
    d = np.abs(got.numpy() - want)
    assert segs == int(wsegs)
    assert d.max() <= MAX_ERR and np.median(d) <= MEDIAN_ERR


# ---------------------------------------------------------------------------
# Port only, bit for bit
# ---------------------------------------------------------------------------

MESH2 = dict(width=48, height=32, depth=4, seed=6)


@pytest.fixture(scope="module")
def mesh2():
    scene, cam = rtt.models.mesh_scene(2)
    return scene, cam, {spp: _port(scene, cam, samples_per_pixel=spp,
                                   **MESH2) for spp in (2, 3)}


def test_node_exit_off_is_bitwise_on(mesh2):
    scene, cam, frames = mesh2
    got, segs = _port(scene, cam, samples_per_pixel=2, node_exit=False,
                      **MESH2)
    assert torch.equal(got, frames[2][0]) and segs == frames[2][1]


@pytest.mark.parametrize("spp", [2, 3])
def test_equals_k1_plain_version(mesh2, spp):
    """3 spp: the assembly sums a pixel's samples in sample order, as K1."""
    scene, cam, frames = mesh2
    ref, segs = frames[spp]
    k1, k1segs = wfc.render_linear_ref(
        torch.from_numpy(tables.pack_spheres(scene)),
        torch.from_numpy(tables.pack_triangles(scene)),
        tables.camera_vec(cam), parity_plane_sign=False,
        samples_per_pixel=spp, **MESH2)
    assert torch.equal(k1, ref) and k1segs == segs


def test_equals_k4_plain_version(mesh2):
    scene, cam, frames = mesh2
    ref, segs = frames[2]
    st = [torch.from_numpy(np.ascontiguousarray(a))
          for a in wst.build_tri_stream_tables(scene)]
    o, k = wst.sorted_top_order(st[3].numpy(), cam.origin.numpy())
    k4, k4segs = wst.render_linear_stream_ref(
        torch.from_numpy(tables.pack_spheres(scene)), *st,
        tables.camera_vec(cam), top_order=torch.from_numpy(o),
        top_keys=torch.from_numpy(k), samples_per_pixel=2, **MESH2)
    assert torch.equal(k4, ref) and k4segs == segs


def test_depth_zero_is_black():
    scene, cam = rtt.models.mesh_scene(2)
    img, segs = _port(scene, cam, width=20, height=12, samples_per_pixel=2,
                      depth=0)
    assert img.shape == (12, 20, 3) and not img.any() and segs == 0


def test_wrapper_on_cpu_tensors_runs_plain_version(mesh2):
    scene, cam, frames = mesh2
    before = wso.LAUNCHES
    got, segs = _port(scene, cam, plain=False, samples_per_pixel=2, **MESH2)
    assert wso.LAUNCHES == before
    assert torch.equal(got, frames[2][0]) and segs == frames[2][1]


def _prefix(scene, cam, **kw):
    """The plain frame through ``render_linear_sorted``'s body
    (``_render_sorted``), taking its test-only arguments."""
    args, extra = _port_args(scene, cam)
    return wso._render_sorted(*args[:14], args[-1], plain=True,
                              sph_clusters=None, node_exit=True, **extra,
                              **{"seed": 0, **kw})


def _full_n(scene, cam, **kw):
    """The reference: the bounce loop launching and sorting every slot each
    bounce (``full_n``)."""
    return _prefix(scene, cam, full_n=True, **kw)


def test_ray_ids_survive_the_sorts_as_int32_bits():
    """After each sort, plane 13 of the live prefix and the dead tails
    holds every ray index once."""
    scene, cam = rtt.models.mesh_scene(2)
    seen = []
    _prefix(scene, cam, slots=lambda ids: seen.append(ids.clone()),
            width=20, height=12, samples_per_pixel=3, depth=3)
    assert len(seen) == 2
    n = wso.ray_layout(20, 12, 3)[1]
    for ids in seen:
        assert torch.equal(ids.sort().values, torch.arange(n,
                                                           dtype=torch.int32))
    assert not torch.equal(seen[0], torch.arange(n, dtype=torch.int32))
    assert not torch.equal(seen[1], seen[0])      # the sort moved rays


@pytest.mark.parametrize("spp", [2, 3])
def test_live_prefix_is_bitwise_the_full_slot_loop(mesh2, spp):
    """The live-prefix frame and its slot order after every regroup equal
    the full-slot loop's, ray id for ray id; later bounces launch over
    fewer slots."""
    scene, cam, frames = mesh2
    kw = dict(MESH2, samples_per_pixel=spp)
    want_ids, got_ids, slots_run = [], [], []
    want = _full_n(scene, cam, slots=lambda i: want_ids.append(i.clone()),
                   **kw)
    real = wso.sorted_bounce_ref

    def spy(T, cv, state, **k):
        slots_run.append(k["n_rays"] if state is None else state.shape[1])
        return real(T, cv, state, **k)

    wso.sorted_bounce_ref = spy
    try:
        got = _prefix(scene, cam, slots=lambda i: got_ids.append(i.clone()),
                      **kw)
    finally:
        wso.sorted_bounce_ref = real
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert torch.equal(got[0], frames[spp][0]) and got[1] == frames[spp][1]
    assert len(got_ids) == len(want_ids) == MESH2["depth"] - 1
    for a, b in zip(got_ids, want_ids):
        assert torch.equal(a, b)
    n = wso.ray_layout(48, 32, spp)[1]
    assert slots_run[0] == n and all(k % 32 == 0 for k in slots_run)
    assert slots_run[1] < n and slots_run == sorted(slots_run, reverse=True)


def test_rays_that_all_die_on_the_primary_bounce():
    """A camera looking up, away from the mesh and the ground: every ray
    misses on bounce 0,
    the later bounces launch nothing, and the frame (the sky) is the
    full-slot loop's."""
    scene, _ = rtt.models.mesh_scene(2)
    cam = rtt.Camera.new_look_at((0.0, 0.0, 0.0), (0.0, 1.0, 0.2),
                                 (0.0, 1.0, 0.0), 1.0, 1.5)
    kw = dict(width=24, height=16, samples_per_pixel=2, depth=4)
    calls = []
    real = wso.sorted_bounce_ref

    def spy(*a, **k):
        calls.append(k["bounce"])
        return real(*a, **k)

    wso.sorted_bounce_ref = spy
    try:
        got = _prefix(scene, cam, **kw)
    finally:
        wso.sorted_bounce_ref = real
    want = _full_n(scene, cam, **kw)
    assert calls == [0]
    assert torch.equal(got[0], want[0]) and got[1] == want[1] == 24 * 16 * 2
    assert got[0].min() > 0.0


@pytest.mark.parametrize("bad", ["order", "sub_counts", "dtype", "spp",
                                 "state"])
def test_bad_inputs_raise(bad):
    scene, cam = rtt.models.mesh_scene(2)
    args, extra = _port_args(scene, cam)
    args = list(args)
    kw = dict(width=16, height=8, samples_per_pixel=1, depth=2)
    if bad == "order":
        extra["top_order"] = extra["top_order"] + 1
    elif bad == "sub_counts":
        args[3] = args[3] + 40
    elif bad == "dtype":
        args[1] = args[1].double()
    elif bad == "spp":
        kw["samples_per_pixel"] = 0
    if bad == "state":
        T = wso._sorted_tables(*args[:14], sph_clusters=None, **extra)
        with pytest.raises(ValueError):
            wso.sorted_bounce_cuda(
                T, args[-1], torch.zeros(13, 256), n_rays=256, bounce=1,
                primary=False, is_last=True, node_exit=True, width=16,
                height=8, spp=1, side=16, seed_word=0)
        return
    with pytest.raises((TypeError, ValueError)):
        wso.render_linear_sorted(*args, **extra, **kw)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

NAME_MAP = {"pallas": "cuda", "pallas_binned": "cuda_binned",
            "pallas_sorted": "cuda_sorted"}


@pytest.mark.parametrize("name", ["mesh_scene2", "mesh_scene3", "obj10k"])
def test_dispatch_matches_jax(name):
    """The port's decisions on a CUDA device are the JAX package's on a
    TPU, under the name map (decided without a GPU: nothing renders)."""
    if name == "obj10k":
        ts, js = rtt.models.obj_mesh_scene()[0], rt.models.obj_mesh_scene()[0]
    else:
        ts, js = rtt.models.mesh_scene(int(name[-1]))[0], \
            rt.models.mesh_scene(int(name[-1]))[0]
    assert ops.SORTED_MIN_TRIS == jops.SORTED_MIN_TRIS
    for spp in (None, 4, 50, 128, 129, 256):
        for w, h in ((64, 36), (512, 512), (1024, 1024)):
            shape = dict(samples_per_pixel=spp, width=w, height=h)
            want, wpps, _ = jops.resolve_dispatch(js, None, "auto", tpu=True,
                                                  **shape)
            got = ops.resolve_dispatch(ts, None, "auto", "cuda", **shape)
            assert got == (NAME_MAP[want], wpps), (name, shape)


def test_sorted_engine_on_a_cpu_device_raises():
    scene = rtt.models.mesh_scene(3)[0]
    with pytest.raises(ValueError, match="CUDA device"):
        ops.resolve_dispatch(scene, None, "cuda_sorted", "cpu")
    assert ops.resolve_dispatch(scene, None, "torch_sorted", "cpu") == \
        ("torch_sorted", False)


def test_render_linear_fast_sorted_and_banded(monkeypatch):
    """``torch_sorted`` renders the plain K6 frame; banded sorted frames go
    to the streamed engine, K4 on a CUDA device (faked: no GPU here)."""
    scene, cam = rtt.models.mesh_scene(2)
    shape = dict(width=20, height=12, samples_per_pixel=2, depth=3, seed=1)
    got, segs = ops.render_linear_fast(scene, cam, device="cpu",
                                       engine="torch_sorted", **shape)
    want, wsegs = ops.render_linear_fast(scene, cam, device="cpu",
                                         engine="torch", **shape)
    assert torch.equal(got, want) and segs == wsegs
    banded, bsegs = ops.render_linear_fast(
        scene, cam, device="cpu", engine="torch_sorted",
        progress=lambda *a: None, **shape)
    streamed, ssegs = ops.render_linear_fast(
        scene, cam, device="cpu", engine="torch_stream", **shape)
    assert torch.equal(banded, streamed) and bsegs == ssegs
    calls = []

    def fake(scene_, cam_, device, plain):
        calls.append((torch.device(device).type, plain))
        return ((lambda *a, shard_rows, width, **k:
                 (torch.zeros(shard_rows, width, 3), 0)), (), {})

    monkeypatch.setattr(ops, "_stream_call", fake)
    big = rtt.models.obj_mesh_scene()
    for engine in ("auto", "cuda_sorted"):
        ops.render_linear_fast(*big, width=8, height=4,
                               samples_per_pixel=256, depth=2, device="cuda",
                               engine=engine, progress=lambda *a: None)
    assert calls == [("cuda", False), ("cuda", False)]


def test_session_resolves_to_the_sorted_engine():
    """api.RenderSession reports cuda_sorted for an OBJ-10k frame at
    256 spp, the main path of the sorted engine (decided, not rendered)."""
    scene, cam = rtt.models.obj_mesh_scene()
    session = api.RenderSession.from_world(
        scene, cam, 512, 512,
        rtt.Options(samples_per_pixel=256, max_ray_bounces=4), device="cuda")
    assert session.resolved_engine() == "cuda_sorted"
