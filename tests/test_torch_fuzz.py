"""Differential fuzzing of the parity engines, a twin of
``tests/test_fuzz.py``: random scenes (every material kind, spheres and
triangles, negative radii, edge-case floats) at random small sizes through
the port's oracle, the native C++ engine, the port's sequential parity
renderer and the JAX package's must agree bitwise; random valid and
mutated sources must be accepted or rejected alike by the port's parser and
the native one.  The scene generator and the mutations are
``tests/test_fuzz.py``'s own functions (compiled from that file's source,
so importing it builds nothing), drawn with the same seeds.

The fast path is held too: the port's ``render_linear`` (the autograd
twin) against JAX's ``render_linear`` on fuzz seeds 0-7 and 255, within
``FAST_BAR`` (see its comment)."""

import ast
import random
from pathlib import Path

import numpy as np
import pytest

import raytracer_tpu as rt
from raytracer_tpu import parser as jparser
from raytracer_tpu_torch import native, oracle, parser, render

# ir = 0 / degenerate-geometry cases exercise NaN paths on purpose
pytestmark = pytest.mark.filterwarnings("ignore::RuntimeWarning")

ROOT = Path(__file__).resolve().parents[1]


def _fuzz_functions():
    tree = ast.parse((ROOT / "tests" / "test_fuzz.py").read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("_f", "make_source", "_mutate")]
    ns = {"random": random}
    exec(compile(ast.Module(body=body, type_ignores=[]),
                 str(ROOT / "tests" / "test_fuzz.py"), "exec"), ns)
    return ns["make_source"], ns["_mutate"]


make_source, _mutate = _fuzz_functions()


def fuzz_case(seed: int):
    """(source, W, H, spp, depth, seed kwargs) as
    ``tests/test_fuzz.py::TestRenderDifferential`` draws them."""
    src = make_source(seed)
    rng = random.Random(seed ^ 0xABCD)
    w = rng.choice([7, 12, 16])
    h = rng.choice([5, 9, 13])
    spp = rng.choice([1, 2])
    depth = rng.choice([1, 2, 4])
    rseed = rng.choice([0, 1, 987654])
    return src, w, h, spp, depth, ({"seed": rseed} if rseed else {})


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load_library()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


# --- render differential ---------------------------------------------------

class TestRenderDifferential:
    @pytest.mark.parametrize("seed", range(8))
    def test_oracle_native_port_jax_bit_match(self, lib, seed):
        src, w, h, spp, depth, kw = fuzz_case(seed)
        world = parser.parse_input(src)
        ocam, oworld = world.to_oracle()
        ref = oracle.ray_trace(oworld, ocam, w, h, spp, depth, **kw)

        got_native = native.NativeWorld(src).render(
            w, h, samples_per_pixel=spp, max_ray_bounces=depth, **kw)
        assert np.array_equal(got_native, ref), (
            f"seed={seed}: native != oracle (maxdiff "
            f"{np.abs(got_native.astype(int) - ref.astype(int)).max()})"
            f"\nsource:\n{src}")

        got = render.ray_trace_parity(world.to_scene(), world.to_camera(),
                                      w, h, spp, depth, device="cpu", **kw)
        assert np.array_equal(got, ref), (
            f"seed={seed}: port parity != oracle\nsource:\n{src}")

        jw = jparser.parse_input(src)
        got_jax = rt.ray_trace_parity(jw.to_scene(), jw.to_camera(), w, h,
                                      samples_per_pixel=spp, depth=depth,
                                      **kw)
        assert np.array_equal(np.asarray(got_jax), ref), (
            f"seed={seed}: jax parity != oracle\nsource:\n{src}")


# --- the fast path: render_linear against JAX's ----------------------------

# The bar of the fast-path twin on fuzz scenes, as a share of max(1,
# max|image|).  The port rounds every operation; XLA:CPU contracts a*b - c
# into fused multiply-adds (ROADMAP.md §3), so the two differ by float32
# ulps that chains of glass hits amplify.  Over fuzz seeds 0-399, 399
# scenes came within 1e-5 of JAX's render_linear; seed 255 (a 1-spp path
# through two glass spheres) reaches 1.24e-5 at max|image| 1.0, while
# JAX's XLA and Pallas paths agree with each other there to 1.1e-6.  2e-5
# holds that scene with 1.6x room; seeds 0-7 differ by at most 6e-8.
# NaN pixels (ir 0 glass) must be NaN in both.
FAST_BAR = 2e-5


@pytest.mark.parametrize("seed", [*range(8), 255])
def test_render_linear_twin_within_bar(seed):
    src, w, h, spp, depth, kw = fuzz_case(seed)
    seed_kw = dict(seed=kw.get("seed", 0))
    tw, jw = parser.parse_input(src), jparser.parse_input(src)
    got, gseg = render.render_linear(
        tw.to_scene(), tw.to_camera(), width=w, height=h,
        samples_per_pixel=spp, depth=depth, **seed_kw)
    want, wseg = rt.render_linear(
        jw.to_scene(), jw.to_camera(), width=w, height=h,
        samples_per_pixel=spp, depth=depth, **seed_kw)
    got, want = got.detach().numpy(), np.asarray(want)
    assert int(gseg) == int(wseg)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    err = np.abs(got[ok] - want[ok]).max(initial=0.0)
    scale = max(1.0, float(np.abs(want[ok]).max(initial=0.0)))
    assert err <= FAST_BAR * scale, f"seed={seed}: max|diff| {err}\n{src}"


# --- parser differential ---------------------------------------------------

def _port_accepts(src: str) -> bool:
    try:
        parser.parse_input(src)
        return True
    except parser.ParseError:
        return False
    except RecursionError:
        return False


def _native_accepts(lib, src: str) -> bool:
    data = src.encode("utf-8", errors="ignore")
    h = lib.rt_load_world_n(data, len(data))
    if h:
        lib.rt_destroy_world(h)
        return True
    return False


class TestParserDifferential:
    @pytest.mark.parametrize("seed", range(12))
    def test_valid_sources_accepted_by_both(self, lib, seed):
        src = make_source(seed + 1000)
        assert _port_accepts(src), f"seed={seed}\n{src}"
        assert _native_accepts(lib, src), f"seed={seed}\n{src}"

    @pytest.mark.parametrize("seed", range(40))
    def test_mutated_sources_decided_identically(self, lib, seed):
        rng = random.Random(seed)
        src = _mutate(make_source(seed + 2000), rng)
        py = _port_accepts(src)
        cc = _native_accepts(lib, src)
        assert py == cc, (
            f"seed={seed}: port={'accept' if py else 'reject'} "
            f"native={'accept' if cc else 'reject'}\nsource:\n{src!r}")
