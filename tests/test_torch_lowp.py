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
they hold the bf16 path itself.  Then the H100 kernel's packed bfloat16
stage on the CPU: the rounding identity it rests on (one bfloat16 add, sub
or mul is the float64 and the float32 result rounded once, subnormals,
signed zeros and overflow included), its packed table, and a plain model
of its pair order bitwise the plain version's stage."""

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


# ---------------------------------------------------------------------------
# The packed bfloat16 stage of the H100 kernel (sphere_pair_lowp in
# csrc/path_common.cuh): two spheres a packed add / sub / mul.rn.bf16x2, each
# half rounded once.  Held on the CPU by the rounding identity it rests on
# and by a plain model of its pair order against the plain version above.
# ---------------------------------------------------------------------------

THREE_SCENE = ("camera origin 0.0 0.0 0.0 aspect 1.0;\n"
               "material M : Metal color 0.9 0.8 0.7 fuzz 0.1;\n"
               "material D : Diffuse color 0.4 0.6 0.3;\n"
               "material G : Dielectric ir 1.5;\n"
               "sphere center -0.6 0.0 -1.6 radius 0.5 material M;\n"
               "sphere center 0.6 0.1 -1.4 radius 0.45 material D;\n"
               "sphere center 0.0 -0.3 -1.1 radius 0.2 material G;\n")


def _round_bf16(x):
    """float64 values rounded to the nearest bfloat16 (ties to even, past
    the largest finite value to infinity), in float64 arithmetic."""
    x = np.asarray(x, np.float64)
    _, e = np.frexp(x)                       # |x| < 2^e
    lead = np.maximum(e - 1, -126)           # subnormals share 2^-126's
    ulp = np.ldexp(1.0, lead - 7)            # 8 significant bits
    q = np.rint(x / ulp) * ulp               # rint: half to even
    return np.where(np.abs(q) >= 2.0 ** 128, np.copysign(np.inf, x), q)


def _bf16_operands(n=20000, seed=11):
    """Pairs of finite bfloat16 values, as int16 bits: random patterns over
    every exponent (subnormals included), pairs of close exponents (sums
    that cancel or round), values near the overflow boundary, and every
    pairing of signed zeros, the smallest and largest subnormals, the
    smallest normal and the largest finite values."""
    r = np.random.default_rng(seed)
    bits = r.integers(0, 1 << 16, size=(2, n), dtype=np.uint32)
    close = bits.copy()
    close[1] = (close[0] & 0xFF80) ^ (r.integers(0, 1 << 7, n) |
                                      (r.integers(0, 2, n) << 15))
    big = 0x7F00 | r.integers(0, 0x80, size=(2, n), dtype=np.uint32)
    big ^= (r.integers(0, 2, size=(2, n), dtype=np.uint32) << 15)
    special = np.array([0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x807F,
                        0x0080, 0x8080, 0x3F80, 0xBF80, 0x7F7F, 0xFF7F,
                        0x7F7E, 0x0100], np.uint32)
    grid = np.stack(np.meshgrid(special, special)).reshape(2, -1)
    pairs = np.concatenate([bits, close, big, grid], axis=1)
    finite = ((pairs >> 7) & 0xFF) != 0xFF
    pairs = pairs[:, finite.all(axis=0)]
    return pairs.astype(np.uint16).view(np.int16)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_bf16_ops_round_once(op):
    """One bfloat16 add, sub or mul of torch on the CPU is the float64
    result rounded once to bfloat16 and the float32 result rounded to
    bfloat16: float64 (53 bits) and float32 (24 bits) both hold at least
    2 x 8 + 2 significant bits, so rounding their result to bfloat16 is
    the correctly rounded bfloat16 operation (products of two 8-bit
    significands are exact in either; subnormals and overflow included).
    The kernel's add / sub / mul.rn.bf16x2 round each half so; the plain
    version is torch's op."""
    a_bits, b_bits = (torch.from_numpy(x.copy()) for x in _bf16_operands())
    a, b = a_bits.view(torch.bfloat16), b_bits.view(torch.bfloat16)
    fn = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}[op]
    got = fn(a, b)
    exact = _round_bf16(fn(a.double(), b.double()).numpy())
    want64 = torch.from_numpy(exact.astype(np.float32)).to(torch.bfloat16)
    want32 = fn(a.float(), b.float()).to(torch.bfloat16)
    assert not torch.isnan(got).any()
    for want in (want64, want32):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    sub = (a_bits & 0x7F80) == 0
    assert sub.sum() > 100 and (got.view(torch.int16) & 0x7F80 == 0).sum() \
        > 100 and torch.isinf(got).sum() > 100


def test_lowp_sphere_table_layout_and_cache():
    w = rtt.parse_input(THREE_SCENE)
    sph = torch.from_numpy(tables.pack_spheres(w.to_scene()))
    t = wfc.lowp_sphere_table(sph)
    assert t.shape == (2, 4, 2) and t.dtype == torch.bfloat16
    assert t.is_contiguous() and t.element_size() * t[0].numel() == 16
    # row k: cx, cy, cz, r^2 of spheres 2k (first) and 2k + 1
    want = sph[[tables.SPH_CX, tables.SPH_CY, tables.SPH_CZ,
                tables.SPH_R2]].to(torch.bfloat16)
    assert torch.equal(t[0], want[:, 0:2]) and torch.equal(t[1, :, 0],
                                                           want[:, 2])
    # the padding sphere of the odd count: r^2 = -1, so it cannot win
    assert t[1, :, 1].tolist() == [0.0, 0.0, 0.0, -1.0]
    assert wfc.lowp_sphere_table(sph) is t
    sph[tables.SPH_R2, 0] = -0.0         # no longer a sphere; in place
    t2 = wfc.lowp_sphere_table(sph)
    assert t2 is not t and float(t2[0, 3, 0]) == -1.0


def _pair_model(sph, ray):
    """K1-lowp's stage as the H100 kernel takes it: the packed table a pair
    at a time, o - c, half_b = (ocx dx + ocy dy) + ocz dz and c = ((ocx^2 +
    ocy^2) + ocz^2) - r^2 on both halves at once in bfloat16 ops (the ray
    rounded once, in both halves), then each half's roots and the strict
    closest-hit compare in float32, sphere 2k before 2k + 1, a winner's
    centre and material from the float32 table."""
    n = ray[0].shape[0]
    o = [x.to(torch.bfloat16)[:, None].expand(n, 2) for x in ray[:3]]
    d = [x.to(torch.bfloat16)[:, None].expand(n, 2) for x in ray[3:]]
    h = wfc.new_hit(n, ray[0].device)
    cols = sph.t().tolist()
    for k, c in enumerate(wfc.lowp_sphere_table(sph)):
        oc = [o[j] - c[j] for j in range(3)]
        hb = (oc[0] * d[0] + oc[1] * d[1]) + oc[2] * d[2]
        cc = ((oc[0] * oc[0] + oc[1] * oc[1]) + oc[2] * oc[2]) - c[3]
        for half in (0, 1):
            half_b, c_f = hb[:, half].float(), cc[:, half].float()
            disc = half_b * half_b - c_f
            ok = (disc >= 0.0) & (float(c[3, half]) >= 0.0)
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            root1, root2 = -half_b - sq, -half_b + sq
            t = torch.where(root1 > wfc.T_MIN, root1,
                            torch.where(root2 > wfc.T_MIN, root2, wfc.BIG))
            t = torch.where(ok, t, wfc.BIG)
            better = t < h[0]
            if not bool(better.any()):
                continue
            cx, cy, cz, _r, _r2, kind, ar, ag, ab, fz, ir = cols[2 * k + half]
            for j, v in enumerate((t, cx, cy, cz, kind, ar, ag, ab, fz, ir)):
                h[j] = torch.where(better, v, h[j])
    return h


@pytest.mark.parametrize("name", ["default_world", "unit_scene",
                                  "three_spheres"])
def test_packed_pair_order_is_the_plain_stage(name):
    """The pair model, the odd count's padding sphere included, bitwise
    the plain version's sphere-by-sphere bfloat16 stage on 8192 rays (half
    aimed at the spheres, half anywhere; from a numpy seed)."""
    if name == "default_world":
        w = rtt.models.default_world()
    else:
        w = rtt.parse_input(UNIT_SCENE if name == "unit_scene"
                            else THREE_SCENE)
    scene, cam = w.to_scene(), w.to_camera()
    sph = torch.from_numpy(tables.pack_spheres(scene))
    r = np.random.default_rng(5)
    n = 8192
    o = np.asarray(cam.origin.numpy(), np.float64) + r.normal(0, 0.2, (n, 3))
    aim = sph[:3].t().numpy()[r.integers(0, sph.shape[1], n)]
    d = np.where(np.arange(n)[:, None] < n // 2,
                 aim + r.normal(0, 0.3, (n, 3)) - o, r.normal(0, 1, (n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = [torch.from_numpy(np.ascontiguousarray(v, np.float32))
           for v in (*o.T, *d.T)]
    want = wfc.new_hit(n, torch.device("cpu"))
    rb = [x.to(torch.bfloat16) for x in ray]
    for col in sph.t().tolist():
        wfc._sphere_step(col, ray, want, None, rb)
    got = _pair_model(sph, ray)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert (want[0] < wfc.BIG).float().mean() > 0.3


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
