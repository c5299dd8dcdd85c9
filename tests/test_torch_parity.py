"""The port's reference-parity path against the JAX package's and the
oracle: the sequential parity renderer (``render.ray_trace_parity``), its
helpers (``closest_hit_exact``, ``scatter_exact``, ``draws_random``,
``random_f32_from_bits``, ``XorShift32``), the oracle copy and the CLI's
``parity=1``.  Tolerance everywhere: none (bitwise, NaN where NaN).

The JAX helpers run eagerly (op by op, as the JAX package's own tests call
them), so XLA fuses nothing into a multiply-add; ``render_parity`` runs as
its jitted scan, as ``tests/test_golden.py`` runs it."""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracer_tpu as rt
from raytracer_tpu import cli as jcli
from raytracer_tpu import intersect as jint
from raytracer_tpu import materials as jmat
from raytracer_tpu import oracle as joracle
from raytracer_tpu import rng as jrng
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import cli, intersect, materials, maths, oracle
from raytracer_tpu_torch import parser, render, rng

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_fuzz import fuzz_case  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")


def _both(src):
    return parser.parse_input(src), rt.parse_input(src)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the golden cases (tests/test_golden.py::TestBitExactParity)
# ---------------------------------------------------------------------------

def _exact_case(world, W, H, spp, depth, seed=None):
    kw = {} if seed is None else {"seed": seed}
    tw, jw = getattr(rtt.models, world)(), getattr(rt.models, world)()
    ocam, oworld = tw.to_oracle()
    ref = oracle.ray_trace(oworld, ocam, W, H, spp, depth, **kw)
    got = render.ray_trace_parity(tw.to_scene(), tw.to_camera(), W, H, spp,
                                  depth, device="cpu", **kw)
    want = np.asarray(rt.ray_trace_parity(jw.to_scene(), jw.to_camera(),
                                          W, H, spp, depth, **kw))
    diff = np.abs(ref.astype(int) - got.astype(int))
    assert diff.max() == 0, (
        f"parity mismatch: max {diff.max()} at "
        f"{np.unravel_index(diff.argmax(), diff.shape)}")
    assert np.array_equal(got, want)
    assert got.dtype == np.uint8 and got.shape == (H, W, 4)


class TestBitExactParity:
    def test_default_world_small(self):
        _exact_case("default_world", 32, 18, 2, 4)

    def test_default_world_more_samples(self):
        _exact_case("default_world", 16, 9, 8, 8)

    def test_triangles(self):
        _exact_case("ffi_example_world", 24, 24, 2, 4)

    def test_sphere_and_ground(self):
        _exact_case("sphere_and_ground", 24, 24, 4, 4)

    def test_custom_seed(self):
        _exact_case("default_world", 16, 9, 2, 3, seed=12345)


def test_oracle_is_the_jax_oracle():
    for src, args in ((rtt.models.default_world_source(), (12, 7, 2, 4)),
                      (rtt.models.ffi_example_source(), (9, 9, 1, 3))):
        tw, jw = _both(src)
        ocam, oworld = tw.to_oracle()
        jcam, jworld = jw.to_oracle()
        for f in ("origin", "lower_left_corner", "horizontal", "vertical"):
            np.testing.assert_array_equal(getattr(ocam, f),
                                          getattr(jcam, f))
        assert np.array_equal(oracle.ray_trace(oworld, ocam, *args),
                              joracle.ray_trace(jworld, jcam, *args))


# ---------------------------------------------------------------------------
# ir 0 glass (ROADMAP.md §3): the parity path follows the oracle's NaN and
# its saturating cast to 0, not K1's blue sky of 1.0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [6, 158])
def test_ir0_glass_nan_cast_to_zero_like_the_oracle(seed):
    src, w, h, spp, depth, kw = fuzz_case(seed)
    assert "ir 0" in src
    world = parser.parse_input(src)
    ocam, oworld = world.to_oracle()
    ref = oracle.ray_trace(oworld, ocam, w, h, spp, depth, **kw)
    colors = render.render_parity(
        world.to_scene(), world.to_camera(), width=w, height=h,
        samples_per_pixel=spp, depth=depth, device="cpu", **kw).numpy()
    nan_px = np.isnan(colors).any(axis=(2, 3))[::-1]
    assert nan_px.any()                      # the NaN path is exercised
    got = render.ray_trace_parity(world.to_scene(), world.to_camera(), w, h,
                                  spp, depth, device="cpu", **kw)
    assert np.array_equal(got, ref)
    # a NaN channel casts to 0 (Rust's saturating `as u8`), blue included
    nan_rgb = np.isnan(colors.sum(axis=2))[::-1]
    assert (got[..., :3][nan_rgb] == 0).all()
    assert nan_rgb[..., 2].any()


# ---------------------------------------------------------------------------
# the helpers, exactly equal to the JAX package's
# ---------------------------------------------------------------------------

def _sqrt_inputs():
    r = np.random.default_rng(0)
    return np.concatenate([r.uniform(0, 4, 2_000_000),
                           np.exp(r.uniform(-80, 80, 2_000_000))]
                          ).astype(np.float32)


def test_sqrt_rn_is_correctly_rounded():
    # numpy's float32 sqrt is IEEE's; torch's vectorised float32 sqrt on
    # the CPU is not always (``python tests/test_torch_parity.py`` counts)
    x = _sqrt_inputs()
    got = maths.sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.sqrt(x).view(np.uint32))
    assert maths.sqrt_rn(torch.tensor([0.0, 4.0])).tolist() == [0.0, 2.0]


def test_random_f32_from_bits_exactly_equal():
    r = np.random.default_rng(11)
    words = np.concatenate([
        np.array([0, 1, 2, 127, 128, 129, 2**24 - 1, 2**24, 2**24 + 1,
                  2**31 - 129, 2**31 - 1, 2**31, 2**31 + 1, 2**31 + 128,
                  2**32 - 129, 2**32 - 128, 2**32 - 2, 2**32 - 1],
                 np.uint64),
        r.integers(0, 2**32, size=4096, dtype=np.uint64)]).astype(np.uint32)
    assert (words >= 2**31).sum() > 1000
    want = np.asarray(jrng.random_f32_from_bits(jnp.asarray(words)))
    got = rng.random_f32_from_bits(_t(words.view(np.int32))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.max() == 1.0 and got.min() == 0.0


@pytest.mark.parametrize("seed", [rng.DEFAULT_SEED, 1, 987654, 2**32 - 1])
def test_xorshift32_host_stream_equal(seed):
    a, b = rng.XorShift32(seed), jrng.XorShift32(seed)
    for _ in range(300):
        assert a.next_u32() == b.next_u32()
    for _ in range(100):
        x, y = a.random_f32(), b.random_f32()
        assert x.dtype == np.float32 and x.view(np.uint32) == y.view(
            np.uint32)
        x, y = a.random_bilateral_f32(), b.random_bilateral_f32()
        assert x.view(np.uint32) == y.view(np.uint32)
    # the device step on int32 words follows the host stream
    s = rng.as_int32(seed).reshape(1)
    c = rng.XorShift32(seed)
    for _ in range(50):
        s = rng.xorshift32(s)
        assert int(rng.as_uint32(s)[0]) == int(c.next_u32())
    with pytest.raises(ValueError):
        rng.XorShift32(0)


# a sphere at t = 1 exactly and a triangle in the plane z = -1 (t = 1
# exactly, either plane sign) on the ray from the origin along -z: the
# triangle wins the tie; two coincident spheres and two coincident
# triangles: the first of each wins
TIE_SOURCE = """camera origin 0.0 0.0 0.0 aspect 1.0;
material A : Diffuse color 0.1 0.2 0.3;
material B : Metal color 0.4 0.5 0.6 fuzz 0.5;
material C : Dielectric ir 1.5;
material D : Emission color 1.0 2.0 3.0;
sphere center 0.0 0.0 -2.0 radius 1.0 material A;
sphere center 0.0 0.0 -2.0 radius 1.0 material B;
sphere center 3.0 0.0 -2.0 radius 1.0 material D;
sphere center 3.0 0.0 -2.0 radius 1.0 material A;
triangle v0 -1.0 -1.0 -1.0 v1 1.0 -1.0 -1.0 v2 0.0 1.0 -1.0 material C;
triangle v0 -1.0 -1.0 -1.0 v1 1.0 -1.0 -1.0 v2 0.0 1.0 -1.0 material D;
"""


def _hit_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-0.5, 0.5, size=(n, 3)).astype(np.float32)
    o[:, 2] += 0.5
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[:4] = 0.0
    d[:4] = [[0, 0, -1], [0.0, 0.6, -0.8], [3.0, 0.0, -2.0],
             [0.0, 0.0, 1.0]]
    d[2] /= np.linalg.norm(d[2])
    return o, d


@pytest.mark.parametrize("name,pps", [("default", True), ("ffi", True),
                                      ("ffi", False), ("ties", True),
                                      ("ties", False)])
def test_closest_hit_exact_equal(name, pps):
    src = {"default": rtt.models.default_world_source(),
           "ffi": rtt.models.ffi_example_source(), "ties": TIE_SOURCE}[name]
    tw, jw = _both(src)
    ts, js = tw.to_scene(), jw.to_scene()
    o, d = _hit_rays(48, seed=5)
    want = jax.vmap(lambda a, b: jint.closest_hit_exact(
        a, b, js, parity_plane_sign=pps))(jnp.asarray(o), jnp.asarray(d))
    for i in range(len(o)):
        got = intersect.closest_hit_exact(_t(o[i]), _t(d[i]), ts, pps)
        for f in ("t", "position", "normal", "mat", "hit"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), np.asarray(getattr(want, f))[i],
                err_msg=f"{name} ray {i} {f}")
    if name == "ties":
        got = intersect.closest_hit_exact(_t(o[0]), _t(d[0]), ts, pps)
        assert float(got.t) == 1.0 and int(got.mat) == 2   # triangle C
        got = intersect.closest_hit_exact(_t(o[2]), _t(d[2]), ts, pps)
        assert int(got.mat) == 3                           # sphere D


MAT_SOURCE = """camera origin 0.0 0.0 0.0 aspect 1.0;
material A : Diffuse color 0.1 0.2 0.3;
material B : Metal color 0.4 0.5 0.6 fuzz 0.3;
material M : Metal color 0.9 0.9 0.9 fuzz 0.0;
material C : Dielectric ir 1.5;
material Z : Dielectric ir 0.0;
material D : Emission color 1.0 2.0 3.0;
"""


def test_scatter_exact_and_draws_random_equal():
    tw, jw = _both(MAT_SOURCE)
    tm, jm = tw.to_scene().materials, jw.to_scene().materials
    r = np.random.default_rng(7)
    B = 96
    mat = np.arange(B, dtype=np.int32) % 6
    d = r.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = r.normal(size=(B, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    ru = r.normal(size=(B, 3)).astype(np.float32)
    ru /= np.linalg.norm(ru, axis=-1, keepdims=True)
    ru[0] = -n[0]                          # degenerate diffuse sum
    n[6] = -d[6]                           # head-on, each kind
    want = jax.vmap(lambda m, a, b, c: jmat.scatter_exact(jm, m, a, b, c))(
        jnp.asarray(mat), jnp.asarray(d), jnp.asarray(n), jnp.asarray(ru))
    draws = jax.vmap(lambda m: jmat.draws_random(jm, m))(jnp.asarray(mat))
    nan_dirs = 0
    for i in range(B):
        m = torch.tensor(mat[i])
        got = materials.scatter_exact(tm, m, _t(d[i]), _t(n[i]), _t(ru[i]))
        for f in ("color", "direction", "terminal"):
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), np.asarray(getattr(want, f))[i],
                err_msg=f"material {mat[i]} sample {i} {f}")
        assert bool(materials.draws_random(tm, m)) == bool(draws[i])
        nan_dirs += bool(np.isnan(got.direction.numpy()).any())
    # ir 0 from inside refracts by 1/0: the reference's NaN direction
    assert nan_dirs > 0
    assert [bool(materials.draws_random(tm, torch.tensor(k)))
            for k in range(6)] == [True, True, True, False, False, False]


def _oracle_samples(world, W, H, spp, depth, seed=rng.DEFAULT_SEED):
    """Each sample's radiance by the oracle's own loop (oracle.ray_trace
    without its finish)."""
    ocam, oworld = world.to_oracle()
    stream = rng.XorShift32(seed)
    f32 = np.float32
    out = np.zeros((H, W, spp, 3), np.float32)
    for row in range(H):
        for col in range(W):
            for s in range(spp):
                u = (f32(col) + stream.random_f32()) / f32(W - 1)
                v = (f32(row) + stream.random_f32()) / f32(H - 1)
                o, d = ocam.cast_ray(u, v)
                out[row, col, s] = oracle.ray_color(o, d, oworld, stream,
                                                    depth)
    return out


@pytest.mark.parametrize("name", ["default_world", "ffi_example_world"])
def test_render_parity_samples_are_the_oracles(name):
    # per-sample radiance bitwise the oracle's; JAX's jitted scan agrees
    # with the oracle only after the u8 finish (its floats differ by ulps:
    # XLA:CPU fuses multiply-adds inside the scan)
    tw = getattr(rtt.models, name)()
    colors = render.render_parity(tw.to_scene(), tw.to_camera(), width=6,
                                  height=4, samples_per_pixel=2, depth=4,
                                  device="cpu")
    assert colors.shape == (4, 6, 2, 3) and colors.dtype == torch.float32
    np.testing.assert_array_equal(colors.numpy(),
                                  _oracle_samples(tw, 6, 4, 2, 4))


def test_parity_entry_points_default_to_cuda():
    import inspect
    for fn in (render.render_parity, render.ray_trace_parity):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():       # no silent fall back to the CPU
        tw = rtt.models.default_world()
        with pytest.raises((RuntimeError, AssertionError)):
            render.ray_trace_parity(tw.to_scene(), tw.to_camera(), 2, 2, 1,
                                    1)


# ---------------------------------------------------------------------------
# the CLI (tests/test_api.py::TestCLI::test_main_parity_mode)
# ---------------------------------------------------------------------------

def test_main_parity_mode(tmp_path, capsys):
    scene = tmp_path / "w.txt"
    scene.write_text(
        "camera origin 0.0 0.0 0.0 aspect 1.0;\n"
        "material G : Diffuse color 0.8 0.8 0.0;\n"
        "sphere center 0.0 -100.5 -1.0 radius 100.0 material G;\n")
    args = [f"scene={scene}", "samples=1", "ray_depth=2", "width=16",
            "parity=1", "use_scene_camera=1"]
    out, jout = tmp_path / "p.ppm", tmp_path / "j.ppm"
    assert cli.main(args + ["device=cpu", f"out={out}"]) == 0
    assert "[stats]" not in capsys.readouterr().err
    assert jcli.main(args + [f"out={jout}"]) == 0
    assert out.read_bytes() == jout.read_bytes()
    assert out.read_bytes().startswith(b"P3\n16 16\n255\n")


if __name__ == "__main__":
    x = _sqrt_inputs()
    want = np.sqrt(x)
    off = int((torch.sqrt(torch.from_numpy(x)).numpy() != want).sum())
    rn = int((maths.sqrt_rn(torch.from_numpy(x)).numpy() != want).sum())
    print(f"torch.sqrt (float32, CPU, torch {torch.__version__}): {off} of "
          f"{x.size} seeded inputs not correctly rounded "
          f"({100 * off / x.size:.2f}%); maths.sqrt_rn: {rn}")
