"""The port's embedding API, CLI and image IO.  The CLI's framebuffer is
held within 1 LSB of the JAX CLI's for the same arguments (a value within
1e-5 of a truncation boundary may round either way)."""

import numpy as np
import pytest
import torch

from raytracer_tpu import cli as jcli
from raytracer_tpu import image as jimage
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import api, cli, image

SRC = rtt.models.DEFAULT_WORLD_SOURCE


def test_load_world_accepts_nul_terminated_bytes():
    a = api.load_world(SRC)
    b = api.load_world(SRC.encode() + b"\x00trailing garbage")
    for f in ("sphere_center", "sphere_radius", "sphere_mat"):
        assert torch.equal(getattr(a.scene, f), getattr(b.scene, f))
    assert torch.equal(a.camera.origin, b.camera.origin)
    assert b.parsed.spheres == a.parsed.spheres


def test_render_and_move_camera_position():
    h = api.load_world(SRC)
    opts = rtt.Options(samples_per_pixel=2, max_ray_bounces=3, device="cpu")
    fb = api.render(h, 16, 9, opts)
    assert fb.shape == (9, 16, 4) and fb.dtype == np.uint8
    moved = api.move_camera_position(h, 0.0, 0.5, 0.0)
    assert float(moved.camera.origin[1]) == 0.5
    assert float(h.camera.origin[1]) == 0.0       # the handle is not mutated
    assert not np.array_equal(api.render(moved, 16, 9, opts), fb)
    assert api.FFI_DEFAULT_OPTIONS.samples_per_pixel == 16


def test_session_frame_changes_after_move():
    s = api.RenderSession(SRC, 16, 9, rtt.Options(
        samples_per_pixel=1, max_ray_bounces=3), device="cpu")
    assert s.options.device == "cpu"
    f0 = s.frame()
    assert s.frame() is f0                         # clean camera: cached
    s.move_camera(0.3, 0.0, 0.0)
    assert not np.array_equal(s.frame(), f0)


def test_session_progressive_refines():
    s = api.RenderSession(SRC, 16, 9, rtt.Options(
        samples_per_pixel=1, max_ray_bounces=3), device="cpu",
        progressive=True, max_samples=3)
    frames = [s.frame().copy()]
    assert s.samples_accumulated == 1
    for spp in (2, 3):
        frames.append(s.frame().copy())
        assert s.samples_accumulated == spp
    assert not np.array_equal(frames[0], frames[2])
    s.frame()
    assert s.samples_accumulated == 3              # capped at max_samples
    s.move_camera(0.0, 0.1, 0.0)
    s.frame()
    assert s.samples_accumulated == 1              # a move resets


def test_session_from_world_and_save(tmp_path):
    scene, cam = rtt.models.mesh_scene(subdivisions=1)
    s = api.RenderSession.from_world(scene, cam, 12, 8, rtt.Options(
        samples_per_pixel=1, max_ray_bounces=2), device="cpu")
    s.save(str(tmp_path / "f.png"))
    s.save(str(tmp_path / "f.ppm"))
    assert np.array_equal(image.read_ppm(str(tmp_path / "f.ppm")), s.frame())
    assert (tmp_path / "f.png").read_bytes().startswith(b"\x89PNG")


def test_cli_matches_jax_cli(tmp_path, capsys):
    args = ["width=32", "samples=2", "ray_depth=3"]
    ours, theirs = tmp_path / "port.ppm", tmp_path / "jax.ppm"
    assert cli.main(args + [f"out={ours}", "device=cpu"]) == 0
    assert jcli.main(args + [f"out={theirs}"]) == 0
    got, want = image.read_ppm(str(ours)), jimage.read_ppm(str(theirs))
    assert got.shape == want.shape == (17, 32, 4)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    err = capsys.readouterr().err
    assert "Scanline: 0" in err and "ray segments" in err


def test_cli_cuda_without_gpu_exits_nonzero(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["width=16", f"out={tmp_path / 'x.ppm'}"])   # device=cuda
    assert e.value.code not in (0, None)
    assert "no CUDA GPU" in str(e.value.code)
    assert not (tmp_path / "x.ppm").exists()


# the name and id are kept from when ``parity=1`` exited as unported
@pytest.mark.parametrize("arg", ["parity=1"], ids=["parity=1-parity renderer"])
def test_cli_unported_options_exit_with_message(arg, tmp_path, capsys):
    # the sequential parity renderer on the CLI's device, no [stats] line
    out = tmp_path / "p.ppm"
    assert cli.main([arg, "device=cpu", "width=8", "samples=1",
                     "ray_depth=1", f"out={out}"]) == 0
    assert image.read_ppm(str(out)).shape == (4, 8, 4)
    assert "[stats]" not in capsys.readouterr().err


def test_cli_arguments():
    assert cli.get_arguments([]) == jcli.get_arguments([])
    args = ["samples=7", "ray_depth=3", "width=64", "seed=9",
            "scene=w.txt", "out=a.png"]
    assert cli.get_arguments(args) == jcli.get_arguments(args)
    assert cli.get_arguments(["device=cpu"])[2] == {"device": "cpu"}
    for bad in (["bogus=1"], ["samples"]):
        with pytest.raises(SystemExit):
            cli.get_arguments(bad)
    with pytest.raises(SystemExit):
        cli.main(["device=tpu"])


def test_ppm_and_png_bytes_match_jax(tmp_path):
    r = np.random.default_rng(1)
    fb = r.integers(0, 256, size=(5, 7, 4), dtype=np.uint8)
    image.write_ppm(fb, str(tmp_path / "a.ppm"))
    jimage.write_ppm(fb, str(tmp_path / "b.ppm"))
    assert (tmp_path / "a.ppm").read_bytes() == \
        (tmp_path / "b.ppm").read_bytes()
    np.testing.assert_array_equal(image.read_ppm(str(tmp_path / "a.ppm"))
                                  [..., :3], fb[..., :3])
    assert image.png_bytes(fb) == jimage.png_bytes(fb)
    assert image.png_bytes(fb[..., :3]) == jimage.png_bytes(fb[..., :3])
    with pytest.raises(ValueError):
        image.write_ppm(fb.astype(np.float32), str(tmp_path / "c.ppm"))
