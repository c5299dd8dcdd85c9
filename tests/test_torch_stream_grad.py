"""The two-level walk of the differentiable path against the JAX package's
streamed kernels: ops/diff.py's leaf-aligned tables and tops, and the plain
versions of K2 (``render_linear_ref(tri_stream=...)``) and K5s
(``grad_slab_ref(tri_stream=...)``), on the same inputs.

Bars: the cull topology, the walk decision, the column map and the tops
equal bit for bit; the aligned table within 1e-6 * max|ref| (the packers'
bar in tests/test_torch_diff.py: XLA:CPU fuses the cross products into
multiply-adds), and at 164k, where JAX's table is not built, bit for bit
the port's packed columns through the column map; the plain K2 image within 1e-5 with equal segments
(measured: 6.0e-8); value and gradient of the loss against JAX's forced
streamed ``make_loss_fn(engine="pallas", interpret=True)``: loss within
1e-5, gradients within 1e-4 * max|ref| + 1e-7 (the bars of
tests/test_torch_grad.py; measured: loss gaps 1.5e-8, gradient gaps at most
2.2e-7 * max|ref|).  Port-only and bitwise: the two-level walk equals the
one-level walk over the same leaves (image, segments, slab, reduced
cotangents, loss gradients)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import grad as jgrad
from raytracer_tpu.ops import diff as jdiff
from raytracer_tpu.ops.pallas import wavefront as jwf
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import grad as tgrad
from raytracer_tpu_torch.ops import diff as tdiff
from raytracer_tpu_torch.ops import tables
from raytracer_tpu_torch.ops.cuda import wavefront as twf
from raytracer_tpu_torch.ops.cuda import wavefront_bwd as twb
from test_torch_mesh_tables import _big


# name: (scene constructor, past the table budget)
SCENES = {"mesh_scene(2)": (lambda m: m.models.mesh_scene(2), False),
          "obj_mesh_scene": (lambda m: m.models.obj_mesh_scene(), False),
          "164k": (_big, True)}


@pytest.fixture(scope="module")
def built():
    """name -> (port scene, JAX scene), each with its default cull built."""
    out = {}
    for name, (make, _) in SCENES.items():
        ts, js = make(rtt)[0], make(rt)[0]
        out[name] = (ts, js, tdiff.build_tri_cull(ts),
                     jdiff.build_tri_cull(js))
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_walk_decision_and_leaf_size_match_jax(built, name):
    ts, js, tc, jc = built[name]
    from raytracer_tpu.ops import pallas_table_bytes
    assert tdiff.table_bytes(ts) == pallas_table_bytes(js)
    assert tdiff._needs_stream(ts) == jdiff._needs_stream(js) \
        == SCENES[name][1]
    for f in ("perm", "ranges", "leaf_ids"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f))
    counts = tc.ranges[1] - tc.ranges[0]
    want = tdiff.STREAM_LEAF_PAD if SCENES[name][1] else tdiff.LEAF_SIZE
    assert counts.max() <= want < 2 * counts.max()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_stream_layout_matches_jax(built, name):
    ts, js, tc, jc = built[name]
    colmap = tdiff._stream_colmap(tc)
    np.testing.assert_array_equal(colmap, jdiff._stream_colmap(jc))
    assert tdiff._stream_colmap(tc) is colmap                     # cached
    assert tc.on("cpu", "src") is tc.on("cpu", "src")
    got = tdiff.tri_stream_table(ts, tc).detach()
    with torch.no_grad():
        assert torch.equal(tdiff.walk_tables(ts, tc, True)["aligned"], got)
    got = got.numpy()
    assert got.shape == (
        tdiff.STREAM_ROWS_PAD, tdiff.STREAM_LEAF_PAD * tc.ranges.shape[1])
    assert not got[:, colmap < 0].any()
    if SCENES[name][1]:
        # the 164k table: the port's packed columns gathered through the
        # column map checked above (the packers are held to JAX's on the
        # other scenes, here and in tests/test_torch_diff.py)
        packed = tdiff.pack_triangles(ts, perm=tc.perm).detach().numpy()
        rows = packed.shape[0]
        np.testing.assert_array_equal(got[:rows, colmap >= 0],
                                      packed[:, colmap[colmap >= 0]])
        assert not got[rows:].any()
    else:
        want = np.asarray(jdiff.tri_stream_table_jnp(js, jc))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    tb, tr = tdiff.tri_stream_tops(tc, tdiff.tri_cluster_bounds(ts, tc))
    jb, jr = jdiff.tri_stream_tops(jc, jdiff.tri_cluster_bounds_jnp(js, jc))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert tr.dtype == torch.int32


def test_ragged_top_gets_the_sentinels():
    """mesh_scene(2)'s 8 leaves make one ragged top: its box is the union
    of its leaves' boxes and of the +1 / -1 sentinels."""
    scene, _ = rtt.models.mesh_scene(2)
    cull = tdiff.build_tri_cull(scene)
    b = tdiff.tri_cluster_bounds(scene, cull)
    C = cull.ranges.shape[1]
    assert C % 16
    tb, tr = tdiff.tri_stream_tops(cull, b)
    assert tr.tolist() == [[0], [C]]
    lo = torch.minimum(b[:3].amin(dim=1), torch.ones(3))
    hi = torch.maximum(b[3:].amax(dim=1), -torch.ones(3))
    assert torch.equal(tb[:, 0], torch.cat([lo, hi]))


def _sub_boxes_brute_force(scene, cull):
    """(6, 4 C) float32: numpy boxes of each leaf's 32-column sub-leaves,
    vertex by vertex, with tri_cluster_bounds' padding; empty sub-leaves
    (past the leaf's count) get the lo = +1 / hi = -1 sentinel."""
    h = scene.numpy()
    verts = np.stack([np.asarray(a, np.float32)
                      for a in (h.tri_v0, h.tri_v1, h.tri_v2)])
    C = cull.ranges.shape[1]
    out = np.empty((6, 4 * C), np.float32)
    for k in range(C):
        s, e = cull.ranges[:, k]
        for j in range(4):
            mem = cull.perm[s + 32 * j:min(s + 32 * j + 32, e)]
            if not len(mem):
                out[:, 4 * k + j] = [1, 1, 1, -1, -1, -1]
                continue
            v = verts[:, mem].reshape(-1, 3)
            lo, hi = v.min(axis=0), v.max(axis=0)
            pad = np.float32(1e-4) + np.float32(1e-5) * np.maximum(
                np.abs(lo), np.abs(hi))
            out[:3, 4 * k + j], out[3:, 4 * k + j] = lo - pad, hi + pad
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sub_leaf_boxes_match_brute_force(built, name):
    """tri_sub_bounds against a numpy box per 32-column sub-leaf, bit for
    bit: full, ragged (a leaf's last, partly filled sub-leaf) and empty
    sub-leaves; walk_tables carries the same table."""
    ts, _, tc, _ = built[name]
    got = tdiff.tri_sub_bounds(ts, tc)
    assert got.dtype == torch.float32 and got.shape == (6, 4 * tc.ranges.shape[1])
    want = _sub_boxes_brute_force(ts, tc)
    np.testing.assert_array_equal(got.numpy(), want)
    counts = tc.ranges[1] - tc.ranges[0]
    if name == "mesh_scene(2)":                 # leaves of 41 and 42
        assert (counts % 32 != 0).all() and (counts < 96).all()
    with torch.no_grad():
        t = tdiff.walk_tables(ts, tc, True)
    assert torch.equal(t["subs"], got)
    # each sub-leaf box lies inside its leaf's box
    leaf = tdiff.tri_cluster_bounds(ts, tc).repeat_interleave(4, dim=1)
    live = (got[0] <= got[3])
    assert (got[:3, live] >= leaf[:3, live]).all()
    assert (got[3:, live] <= leaf[3:, live]).all()


def test_sub_leaf_boxes_follow_the_live_vertices():
    """The boxes are recomputed from the vertices on every call: after an
    optimiser-like move they bound the moved triangles, not the old ones."""
    scene, _ = rtt.models.mesh_scene(2)
    cull = tdiff.build_tri_cull(scene)
    before = tdiff.tri_sub_bounds(scene, cull)
    shift = torch.from_numpy(np.random.default_rng(1).normal(
        0.0, 0.05, tuple(scene.tri_v0.shape)).astype(np.float32))
    moved = tgrad.apply_params(scene, {"tri_v0": scene.tri_v0 + shift})
    after = tdiff.tri_sub_bounds(moved, cull)
    assert not torch.equal(before, after)
    np.testing.assert_array_equal(after.numpy(),
                                  _sub_boxes_brute_force(moved, cull))


# ---------------------------------------------------------------------------
# the plain versions of K2 and K5s against the JAX streamed kernels
# ---------------------------------------------------------------------------

SHAPE = dict(width=16, height=12, samples_per_pixel=1, depth=2, seed=3,
             parity_plane_sign=False)
# name: (scene constructor, leaf size: mesh_scene(3) at 16 makes 128
# leaves, 8 tops; OBJ-10k at 128 makes 128 leaves of 80, 8 tops)
WALKS = {"mesh3_leaf16": (lambda m: m.models.mesh_scene(3), 16),
         "obj10k_leaf128": (lambda m: m.models.obj_mesh_scene(), 128)}


def _port_tables(scene, cull):
    with torch.no_grad():
        return tdiff.walk_tables(scene, cull, two_level=True)


def test_plain_k2_matches_pallas_stream_interpret():
    (ts, tc), (js, jc) = (WALKS["mesh3_leaf16"][0](m) for m in (rtt, rt))
    tcull, jcull = (tdiff.build_tri_cull(ts, 16),
                    jdiff.build_tri_cull(js, 16))
    assert tcull.ranges.shape[1] == 128
    t = _port_tables(ts, tcull)
    assert t["tops"][0].shape[1] == 8
    got, gseg = twf.render_linear_ref(
        t["sph"], t["aligned"], tables.camera_vec(tc),
        tri_clusters=t["clusters"], tri_stream=t["tops"], **SHAPE)
    jb = jdiff.tri_cluster_bounds_jnp(js, jcull)
    trit = jdiff.tri_stream_tops(jcull, jb)
    want, wseg = jwf.render_linear_pallas(
        jdiff.pack_spheres_jnp(js), jdiff.tri_stream_table_jnp(js, jcull),
        jwf.camera_vec(jc), tri_clusters=(jb, jnp.asarray(jcull.ranges)),
        tri_stream=trit, stream_tops=int(trit[1].shape[1]), block_rows=16,
        interpret=True, **SHAPE)
    assert int(gseg) == int(wseg)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


FIELDS = ("tri_v0", "mat_color")


@pytest.fixture(scope="module", params=sorted(WALKS))
def walk_case(request, monkeypatch_module):
    """Loss value and gradients at a seeded random target: JAX's streamed
    kernel path (interpret mode), and the port's kernel path (K2 + K5s
    plain versions) forced streamed and not (one level, same leaves)."""
    make, leaf = WALKS[request.param]
    (ts, tc), (js, jc) = make(rtt), make(rt)
    H, W = SHAPE["height"], SHAPE["width"]
    target = np.random.default_rng(5).uniform(0.0, 1.0, (H, W, 3)).astype(
        np.float32)
    jdiff.build_tri_cull(js, leaf)          # the loss picks the cached cull
    tcull = tdiff.build_tri_cull(ts, leaf)
    params = {k: np.asarray(v)
              for k, v in jgrad.extract_params(js, list(FIELDS)).items()}
    kw = dict(width=W, height=H, samples_per_pixel=SHAPE["samples_per_pixel"],
              depth=SHAPE["depth"], seed=SHAPE["seed"],
              parity_plane_sign=False)
    monkeypatch_module.setattr(jdiff, "_needs_stream", lambda s: True)
    jloss = jgrad.make_loss_fn(js, jc, jnp.asarray(target), engine="pallas",
                               interpret=True, **kw)
    v, g = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(p) for k, p in params.items()})
    out = {"jax": (float(v), {k: np.asarray(x) for k, x in g.items()}),
           "cull": tcull}
    calls = []
    stage = twf.stream_tri_stage
    monkeypatch_module.setattr(twf, "stream_tri_stage",
                               lambda *a: calls.append(1) or stage(*a))
    for walk, forced in (("two_level", True), ("one_level", False)):
        monkeypatch_module.setattr(tdiff, "_needs_stream",
                                   lambda s, f=forced: f)
        calls.clear()
        p = tgrad.params_from_arrays(params, "cpu")
        for x in p.values():
            x.requires_grad_(True)
        loss = tgrad.make_loss_fn(ts, tc, torch.from_numpy(target),
                                  engine="pallas", device="cpu", **kw)(p)
        loss.backward()
        out[walk] = (float(loss.detach()),
                     {k: x.grad.numpy() for k, x in p.items()}, len(calls))
    monkeypatch_module.undo()
    return out


def test_loss_matches_jax_streamed(walk_case):
    assert abs(walk_case["two_level"][0] - walk_case["jax"][0]) < 1e-5


@pytest.mark.parametrize("field", FIELDS)
def test_gradients_match_jax_streamed(walk_case, field):
    got, want = walk_case["two_level"][1][field], walk_case["jax"][1][field]
    assert np.isfinite(got).all() and np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 1e-7


def test_forced_walk_takes_both_plain_stages(walk_case):
    """The forward and the backward each ran the two-level walk when forced,
    and neither did otherwise."""
    assert walk_case["two_level"][2] == 2 and walk_case["one_level"][2] == 0


def test_two_level_loss_gradients_bitwise_one_level(walk_case):
    v2, g2, _ = walk_case["two_level"]
    v1, g1, _ = walk_case["one_level"]
    assert v2 == v1
    for k in FIELDS:
        np.testing.assert_array_equal(g2[k], g1[k])


def test_two_level_walk_bitwise_one_level_walk():
    """Plain K2 / K5s over a topology against plain K1 / K5 over the packed
    table and the same leaves: image, segments, slab and cotangents."""
    scene, cam = rtt.models.mesh_scene(3)
    cull = tdiff.build_tri_cull(scene, 16)
    t = _port_tables(scene, cull)
    cv = tables.camera_vec(cam)
    kw = dict(SHAPE, depth=3)
    one = twf.render_linear_ref(t["sph"], t["packed"], cv,
                                tri_clusters=t["clusters"], **kw)
    two = twf.render_linear_ref(t["sph"], t["aligned"], cv,
                                tri_clusters=t["clusters"],
                                tri_stream=t["tops"], **kw)
    assert torch.equal(one[0], two[0]) and one[1] == two[1]
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (SHAPE["height"], SHAPE["width"], 3)).astype(np.float32))
    T = t["packed"].shape[1]
    s1, c1 = twb.grad_slab_ref(t["sph"], t["packed"], g, cv,
                               tri_clusters=t["clusters"], **kw)
    s2, c2 = twb.grad_slab_ref(t["sph"], t["aligned"], g, cv,
                               tri_clusters=t["clusters"],
                               tri_stream=t["tops"], n_tris_packed=T, **kw)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)
    assert (s2[:, :, twb.GP_WIN] >= t["sph"].shape[1]).any()
    got = twb.render_grad_cuda(t["sph"], t["aligned"], g, cv,
                               tri_clusters=t["clusters"],
                               tri_stream=t["tops"], n_tris_packed=T, **kw)
    want = twb.reduce_slab(s1, c1, t["sph"].shape[1], T)
    assert got[1].shape == (tables.TRI_ROWS, T)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cpu_wrappers_take_the_plain_walk_and_count_nothing():
    scene, cam = rtt.models.mesh_scene(2)
    cull = tdiff.build_tri_cull(scene)
    t = _port_tables(scene, cull)
    cv = tables.camera_vec(cam)
    before = (twf.STREAM_LAUNCHES, twb.STREAM_LAUNCHES)
    got = twf.render_linear_cuda(t["sph"], t["aligned"], cv,
                                 tri_clusters=t["clusters"],
                                 tri_stream=t["tops"], **SHAPE)
    want = twf.render_linear_ref(t["sph"], t["aligned"], cv,
                                 tri_clusters=t["clusters"],
                                 tri_stream=t["tops"], **SHAPE)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert (twf.STREAM_LAUNCHES, twb.STREAM_LAUNCHES) == before


def test_gradient_pass_hands_the_sub_leaf_boxes_to_both_walks(monkeypatch):
    """render_linear_diff's two-level pass gives K2 and K5s (here their
    plain versions) walk_tables' sub-leaf boxes."""
    scene, cam = rtt.models.mesh_scene(3)
    cull = tdiff.build_tri_cull(scene, 16)
    monkeypatch.setattr(tdiff, "_needs_stream", lambda s: True)
    seen = []
    for mod, fn in ((twf, "render_linear_cuda"), (twb, "render_grad_cuda")):
        real = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, real=real, **k: (
            seen.append(k["sub_bounds"]), real(*a, **k))[1])
    p = tgrad.extract_params(scene, ["mat_color"])
    p["mat_color"].requires_grad_(True)
    s = tgrad.apply_params(scene, p)
    img = tdiff.render_linear_diff(s, cam, tri_cull=cull, **SHAPE)
    img.sum().backward()
    want = tdiff.tri_sub_bounds(scene, cull)
    assert len(seen) == 2 and all(torch.equal(b, want) for b in seen)
    assert torch.isfinite(p["mat_color"].grad).all()


@pytest.mark.parametrize("bad", ["no_clusters", "slot_width", "no_packed",
                                 "packed_short", "leaf_too_big",
                                 "sub_bounds_shape", "top_too_wide",
                                 "sub_bounds_one_level"])
def test_bad_stream_inputs_raise(bad):
    scene, cam = rtt.models.mesh_scene(2)
    cull = tdiff.build_tri_cull(scene)
    t = _port_tables(scene, cull)
    cv = tables.camera_vec(cam)
    g = torch.zeros(SHAPE["height"], SHAPE["width"], 3)
    args = dict(tri_clusters=t["clusters"], tri_stream=t["tops"],
                n_tris_packed=t["packed"].shape[1])
    tri = t["aligned"]
    if bad == "no_clusters":
        args["tri_clusters"] = None
    elif bad == "slot_width":
        tri = tri[:, :-1].contiguous()
    elif bad == "no_packed":
        args["n_tris_packed"] = None
    elif bad == "packed_short":
        args["n_tris_packed"] = 10
    elif bad == "leaf_too_big":
        b, r = t["clusters"]
        r = r.clone()
        r[1, 0] = r[0, 0] + tdiff.STREAM_LEAF_PAD + 1
        args["tri_clusters"] = (b, r)
    elif bad == "sub_bounds_shape":
        args["sub_bounds"] = t["subs"][:, :-1].contiguous()
    elif bad == "top_too_wide":
        # one top over 17 leaves (the kernels stage a top through a 64-bit
        # mask of 16 leaves' sub-leaves)
        scene3 = rtt.models.mesh_scene(3)[0]
        cull16 = tdiff.build_tri_cull(scene3, 16)
        t = _port_tables(scene3, cull16)
        tri = t["aligned"]
        b, r = t["tops"]
        r = r.clone()
        r[1, 0] = 17
        args = dict(tri_clusters=t["clusters"], tri_stream=(b, r),
                    n_tris_packed=t["packed"].shape[1])
    else:
        args = dict(tri_clusters=t["clusters"], sub_bounds=t["subs"])
        tri = t["packed"]
    with pytest.raises(ValueError):
        twb.grad_slab_ref(t["sph"], tri, g, cv, **SHAPE, **args)
    if "packed" not in bad:             # K2 takes no packed column count
        args.pop("n_tris_packed", None)
        with pytest.raises(ValueError):
            twf.render_linear_ref(t["sph"], tri, cv, **SHAPE, **args)
