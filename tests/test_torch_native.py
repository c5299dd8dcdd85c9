"""The port's native runtime (``raytracer_tpu_torch.native``: ctypes over
``native/raytracer_core.cpp``, built under ``build/`` with
``native/Makefile``'s flags), a twin of ``tests/test_native.py``.  In
parity mode the C++ engine must BIT-MATCH the port's oracle, the port's
sequential parity renderer and the JAX package's, on the same inputs.
Tests skip only where the library cannot be had (no C++ compiler)."""

import re
from pathlib import Path

import numpy as np
import pytest

import raytracer_tpu as rt
from raytracer_tpu import image as jimage
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import image, native, oracle, parser

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load_library()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


def _parity_case(src, W, H, spp, depth, seed=None):
    """native == port oracle == port parity == JAX parity, bitwise."""
    kw = {} if seed is None else {"seed": seed}
    got = native.NativeWorld(src).render(W, H, samples_per_pixel=spp,
                                         max_ray_bounces=depth, **kw)
    world = parser.parse_input(src)
    ocam, oworld = world.to_oracle()
    ref = oracle.ray_trace(oworld, ocam, W, H, spp, depth, **kw)
    assert np.array_equal(got, ref), (
        f"native/oracle mismatch: "
        f"{np.abs(got.astype(int) - ref.astype(int)).max()}")
    port = rtt.ray_trace_parity(world.to_scene(), world.to_camera(), W, H,
                                spp, depth, device="cpu", **kw)
    assert np.array_equal(port, ref)
    jw = rt.parse_input(src)
    jax_img = rt.ray_trace_parity(jw.to_scene(), jw.to_camera(), W, H, spp,
                                  depth, **kw)
    assert np.array_equal(np.asarray(jax_img), ref)


class TestNativeParity:
    def test_default_world_bit_exact(self, lib):
        _parity_case(rtt.models.default_world_source(), 32, 18, 2, 4)

    def test_triangles_bit_exact(self, lib):
        _parity_case(rtt.models.ffi_example_source(), 24, 24, 2, 4)

    def test_custom_seed(self, lib):
        _parity_case(rtt.models.default_world_source(), 16, 9, 2, 3,
                     seed=4242)


class TestNativeFastMode:
    def test_fast_mode_renders_and_is_deterministic(self, lib):
        w = native.NativeWorld(rtt.models.default_world_source())
        a = w.render(48, 27, samples_per_pixel=8, max_ray_bounces=4,
                     parity=False, num_threads=4)
        b = w.render(48, 27, samples_per_pixel=8, max_ray_bounces=4,
                     parity=False, num_threads=2)
        # thread count must not change the image (per-pixel counters)
        assert np.array_equal(a, b)
        assert (a[..., 3] == 255).all()

    def test_fast_mode_close_to_parity(self, lib):
        w = native.NativeWorld(rtt.models.default_world_source())
        fast = w.render(32, 18, samples_per_pixel=64, max_ray_bounces=4,
                        parity=False).astype(np.float32)
        par = w.render(32, 18, samples_per_pixel=64, max_ray_bounces=4,
                       parity=True).astype(np.float32)
        err = np.abs(fast[..., :3] - par[..., :3])
        assert err.mean() < 10.0  # MC noise between independent samplings


class TestNativeAPI:
    def test_parse_error(self, lib):
        with pytest.raises(ValueError):
            native.NativeWorld("camera origin 0.0 0.0 aspect 1.0;")

    def test_move_camera(self, lib):
        w = native.NativeWorld(rtt.models.default_world_source())
        p0 = w.camera_position()
        w.move_camera(1.0, 0.5, -0.25)
        p1 = w.camera_position()
        np.testing.assert_allclose(p1 - p0, [1.0, 0.5, -0.25], atol=1e-6)

    def test_ppm_writer_matches_python(self, lib, tmp_path):
        rng = np.random.default_rng(1)
        fb = rng.integers(0, 256, size=(5, 7, 4), dtype=np.uint8)
        p_native, p_jax = tmp_path / "n.ppm", tmp_path / "j.ppm"
        native.write_ppm_native(fb, str(p_native))
        jimage.write_ppm(fb, str(p_jax))
        text = image.format_ppm(fb)
        assert p_native.read_text() == text == p_jax.read_text()
        p_port = tmp_path / "p.ppm"
        image.write_ppm(fb[..., :3], str(p_port))       # RGB: alpha added
        assert p_port.read_text() == text

    def test_nul_terminated_source(self, lib):
        src = "camera origin 0.0 0.0 0.0 aspect 1.0;\x00 garbage"
        w = native.NativeWorld(src)
        assert w.camera_position().shape == (3,)


def test_compiler_flags_are_the_makefiles():
    text = (ROOT / "native" / "Makefile").read_text()
    cxx = re.search(r"^CXXFLAGS \?= (.*)$", text, re.M).group(1).split()
    ld = re.search(r"^LDFLAGS \?= (.*)$", text, re.M).group(1).split()
    assert list(native.CXX_FLAGS) == cxx + [f for f in ld if f not in cxx]
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert "-ffast-math" not in native.CXX_FLAGS


def test_library_is_built_under_build(lib):
    path = native.library_path()
    assert path.is_file()
    assert path.parent.parent == ROOT / "build" / "raytracer_tpu_torch" \
        / "native"
    assert Path(lib._name) == path
    assert native.load_library() is lib               # loaded once


def test_write_ppm_falls_back_only_without_the_library(monkeypatch,
                                                       tmp_path):
    fb = np.random.default_rng(2).integers(0, 256, (3, 4, 4), np.uint8)

    def unavailable(*a):
        raise native.NativeUnavailable("no compiler")

    monkeypatch.setattr(native, "write_ppm_native", unavailable)
    image.write_ppm(fb, str(tmp_path / "f.ppm"))
    assert (tmp_path / "f.ppm").read_text() == image.format_ppm(fb)

    def broken(*a):
        raise RuntimeError("native PPM write failed: disk full")

    monkeypatch.setattr(native, "write_ppm_native", broken)
    with pytest.raises(RuntimeError, match="disk full"):
        image.write_ppm(fb, str(tmp_path / "g.ppm"))
    assert not (tmp_path / "g.ppm").exists()


def test_missing_compiler_is_native_unavailable(monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(native.NativeUnavailable):
        native.compiler()
