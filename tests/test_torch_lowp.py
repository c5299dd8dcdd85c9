"""K1-lowp (``render_linear_cuda(lowp=True)``: the sphere quadratic in
bfloat16) through its plain version on the CPU, mirroring
tests/test_pallas.py::TestLowPrecisionIntersect: the default world and a
two-sphere unit scene at 48x32, 2 spp, depth 4, parity plane sign.  Bars
against float32 (the port's K1 and the JAX package's): PSNR > 8 dB on the
default world, whose 100-radius ground sphere cancels catastrophically in
bfloat16, > 22 dB on the unit scene, segments within 25%, the JAX
package's own bars.  Against the JAX package's lowp kernel in interpret
mode (XLA:CPU may keep excess precision across a bf16 chain, so it is not
bitwise): PSNR >= 16 and >= 26 dB, segments within 1% (measured 17.85 and
28.01 dB, segments 0.48% and 0.39% apart).  The port's float32 frame
fails those bars (14.35 and 25.05 dB, segments 2.0% and 5.4% apart), so
they hold the bf16 path itself."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu.ops.pallas import wavefront as jwf
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import ops
from raytracer_tpu_torch.ops import tables
from raytracer_tpu_torch.ops.cuda import wavefront as wfc

KW = dict(width=48, height=32, samples_per_pixel=2, depth=4)
UNIT_SCENE = ("camera origin 0.0 0.0 0.0 aspect 1.0;\n"
              "material M : Metal color 0.9 0.8 0.7 fuzz 0.1;\n"
              "material D : Diffuse color 0.4 0.6 0.3;\n"
              "sphere center -0.6 0.0 -1.6 radius 0.5 material M;\n"
              "sphere center 0.6 0.1 -1.4 radius 0.45 material D;\n")
# name: (PSNR bar against float32, against JAX lowp)
BARS = {"default_world": (8.0, 16.0), "unit_scene": (22.0, 26.0)}
LOWP_SEGMENTS = 0.01    # segments against JAX lowp, relative


def psnr(a, b):
    a, b = np.asarray(a), np.asarray(b)
    mse = float(np.mean((a - b) ** 2))
    peak = float(max(a.max(), 1e-6))
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def _worlds(name):
    if name == "default_world":
        return rtt.models.default_world(), rt.models.default_world()
    return rtt.parse_input(UNIT_SCENE), rt.parse_input(UNIT_SCENE)


@pytest.fixture(scope="module", params=sorted(BARS))
def renders(request):
    """The four frames of one scene: port and JAX, float32 and lowp."""
    tw, jw = _worlds(request.param)
    ts, tc, js, jc = tw.to_scene(), tw.to_camera(), jw.to_scene(), \
        jw.to_camera()
    targs = (torch.from_numpy(tables.pack_spheres(ts)),
             torch.from_numpy(tables.pack_triangles(ts)),
             tables.camera_vec(tc))
    jargs = (jnp.asarray(jwf.pack_spheres(js)),
             jnp.asarray(jwf.pack_triangles(js)), jwf.camera_vec(jc))
    out = {"name": request.param}
    for lowp in (False, True):
        img, segs = wfc.render_linear_ref(*targs, lowp=lowp, **KW)
        out["port", lowp] = (img.numpy(), segs)
        img, segs = jwf.render_linear_pallas(*jargs, lowp=lowp, block_rows=8,
                                             interpret=True, **KW)
        out["jax", lowp] = (np.asarray(img), int(segs))
    return out


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_lowp_tracks_float32(renders, ref):
    img, segs = renders["port", True]
    want, wsegs = renders[ref, False]
    assert np.isfinite(img).all()
    assert psnr(want, img) > BARS[renders["name"]][0]
    assert abs(segs - wsegs) < 0.25 * wsegs


def _meets_lowp_bars(renders, img, segs):
    want, wsegs = renders["jax", True]
    return (psnr(want, img) >= BARS[renders["name"]][1],
            abs(segs - wsegs) <= LOWP_SEGMENTS * wsegs)


def test_lowp_against_jax_lowp(renders):
    assert _meets_lowp_bars(renders, *renders["port", True]) == (True, True)


def test_float32_fails_the_lowp_bars(renders):
    """The bars against JAX lowp tell lowp from float32: the port's float32
    frame misses both."""
    assert _meets_lowp_bars(renders, *renders["port", False]) == (False,
                                                                   False)


def test_port_float32_matches_jax_float32(renders):
    img, segs = renders["port", False]
    want, wsegs = renders["jax", False]
    assert segs == wsegs and np.abs(img - want).max() <= 1e-4


def test_wrapper_on_cpu_tensors_runs_plain_lowp():
    w = rtt.models.default_world()
    args = (torch.from_numpy(tables.pack_spheres(w.to_scene())),
            torch.from_numpy(tables.pack_triangles(w.to_scene())),
            tables.camera_vec(w.to_camera()))
    kw = dict(width=16, height=8, samples_per_pixel=1, depth=3)
    counts = (wfc.LAUNCHES, wfc.LOWP_LAUNCHES)
    got = wfc.render_linear_cuda(*args, lowp=True, **kw)
    assert (wfc.LAUNCHES, wfc.LOWP_LAUNCHES) == counts
    want = wfc.render_linear_ref(*args, lowp=True, **kw)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    f32 = wfc.render_linear_ref(*args, **kw)
    assert not torch.equal(got[0], f32[0])


def test_lowp_scans_spheres_flat():
    """Sphere clusters do not change a lowp frame: the bf16 loop scans the
    (cluster-ordered) table flat, as _sphere_loop_lowp does."""
    scene, cam = rtt.models.random_spheres()
    sph, tri, scl, _ = ops.scene_tables(scene, True, "cpu")
    assert scl is not None
    kw = dict(width=12, height=8, samples_per_pixel=1, depth=2,
              parity_plane_sign=True, lowp=True)
    cv = tables.camera_vec(cam)
    a = wfc.render_linear_ref(sph, tri, cv, sph_clusters=scl, **kw)
    b = wfc.render_linear_ref(sph, tri, cv, **kw)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]


def test_bf16_step_rounds_each_operation():
    """One lowp sphere step against the same chain written out in numpy
    with a bfloat16 round after every operation."""
    import ml_dtypes
    bf = ml_dtypes.bfloat16
    r = np.random.default_rng(3)
    ray = r.uniform(-1.0, 1.0, (6, 64)).astype(np.float32)
    col = [0.3, -0.2, -1.5, 0.5, 0.25, 0.0, 0.5, 0.5, 0.5, 0.0, 1.0]
    h = wfc.new_hit(64, torch.device("cpu"))
    ray_t = [torch.from_numpy(x) for x in ray]
    wfc._sphere_step(col, ray_t, h, None,
                     [x.to(torch.bfloat16) for x in ray_t])

    def b(x):
        return np.asarray(x, np.float32).astype(bf).astype(np.float32)

    o, d = b(ray[:3]), b(ray[3:])
    oc = [b(o[k] - b(np.float32(col[k]))) for k in range(3)]
    hb = b(b(b(oc[0] * d[0]) + b(oc[1] * d[1])) + b(oc[2] * d[2]))
    cc = b(b(b(b(oc[0] * oc[0]) + b(oc[1] * oc[1])) + b(oc[2] * oc[2]))
           - b(np.float32(col[4])))
    disc = hb * hb - cc
    sq = np.sqrt(np.maximum(disc, 0.0))
    r1, r2 = -hb - sq, -hb + sq
    t = np.where(r1 > wfc.T_MIN, r1, np.where(r2 > wfc.T_MIN, r2, wfc.BIG))
    t = np.where(disc >= 0.0, t, wfc.BIG).astype(np.float32)
    np.testing.assert_array_equal(h[0].numpy(), t)
    assert (t < wfc.BIG).any()


if __name__ == "__main__":
    # the figures behind the bars, from the repository root:
    # PYTHONPATH=. python tests/test_torch_lowp.py
    import jax
    jax.config.update("jax_platforms", "cpu")
    for name in sorted(BARS):
        r = renders.__wrapped__(type("Request", (), {"param": name})())
        (pl, ps), (pf, pfs) = r["port", True], r["port", False]
        (jl, jls), (jf, jfs) = r["jax", True], r["jax", False]
        print(f"{name} {KW}: port lowp vs port f32 {psnr(pf, pl):.2f} dB, "
              f"vs JAX f32 {psnr(jf, pl):.2f} dB, vs JAX lowp "
              f"{psnr(jl, pl):.2f} dB; JAX lowp vs JAX f32 "
              f"{psnr(jf, jl):.2f} dB; segments port lowp {ps}, port f32 "
              f"{pfs}, JAX lowp {jls}, JAX f32 {jfs}")
