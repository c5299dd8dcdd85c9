"""The port's viewers (``raytracer_tpu_torch.viewer`` and ``.httpviewer``),
twins of ``tests/test_api.py::TestViewer`` and every class of
``tests/test_httpviewer.py``: a real ``RenderSession`` served over a
loopback socket and driven the way the browser does (frame polls, key
moves).  Sessions render on ``device="cpu"`` here (K1's plain version);
the viewers themselves default to ``cuda``."""

import inspect
import json
import sys
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from raytracer_tpu import viewer as jviewer
import raytracer_tpu_torch as rtt
from raytracer_tpu_torch import httpviewer, viewer
from raytracer_tpu_torch.api import RenderSession
from raytracer_tpu_torch.models import default_world_source
from raytracer_tpu_torch.render import Options


def png_rgba(data: bytes) -> np.ndarray:
    """Decode ``image.png_bytes``' output (RGBA8, filter 0 on each row)."""
    assert data.startswith(b"\x89PNG\r\n\x1a\n")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = (int.from_bytes(body[4:8], "big"),
                    int.from_bytes(body[0:4], "big"))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 4)


# --- the terminal viewer (tests/test_api.py::TestViewer) ---------------------

class TestViewer:
    def test_ansi_blit(self):
        fb = np.zeros((4, 3, 4), np.uint8)
        fb[0, :, 0] = 255  # red top row
        s = viewer.framebuffer_to_ansi(fb)
        lines = s.split("\n")
        assert len(lines) == 2            # 4 pixel rows -> 2 cell rows
        assert "38;2;255;0;0" in lines[0]
        assert "▀" in s
        fb = np.random.default_rng(3).integers(0, 256, (7, 5, 4), np.uint8)
        assert viewer.framebuffer_to_ansi(fb) == \
            jviewer.framebuffer_to_ansi(fb)

    def test_noninteractive_dump(self, capsys, monkeypatch):
        monkeypatch.setattr(sys.stdin, "isatty", lambda: False)
        viewer.run_viewer(width=16, samples=1, depth=1, device="cpu")
        out = capsys.readouterr().out
        assert "▀" in out

    def test_defaults_to_cuda(self):
        for fn in (viewer.run_viewer, httpviewer.serve):
            assert inspect.signature(fn).parameters["device"].default \
                == "cuda"


# --- the HTTP viewer (tests/test_httpviewer.py) ------------------------------

def _serve(session):
    httpd = httpviewer.make_server(session, port=0)  # ephemeral port
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, t):
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.fixture(scope="module")
def server():
    session = RenderSession(default_world_source(), 32, 18,
                            Options(samples_per_pixel=1, max_ray_bounces=2),
                            device="cpu")
    httpd, t, url = _serve(session)
    yield url
    _stop(httpd, t)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


class TestHTTPViewer:
    def test_index_page(self, server):
        status, _, body = _get(server + "/")
        assert status == 200
        assert b"keydown" in body and b"/frame.png" in body

    def test_frame_is_png(self, server):
        status, headers, body = _get(server + "/frame.png")
        assert status == 200
        assert headers["Content-Type"] == "image/png"
        assert png_rgba(body).shape == (18, 32, 4)

    def test_move_changes_camera_and_frame(self, server):
        _, _, before = _get(server + "/frame.png")
        cam0 = json.loads(_get(server + "/camera")[2])
        status, resp = _post(server + "/move",
                             {"dx": 0.0, "dy": 0.0, "dz": -0.5})
        assert status == 200 and resp["generation"] >= 1
        cam1 = json.loads(_get(server + "/camera")[2])
        assert np.allclose(np.array(cam1["origin"]) -
                           np.array(cam0["origin"]), [0.0, 0.0, -0.5])
        _, _, after = _get(server + "/frame.png")
        assert after != before  # dirty-flag re-render happened

    def test_bad_move_rejected(self, server):
        req = urllib.request.Request(server + "/move", data=b"not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 400

    def test_unknown_path_404(self, server):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server + "/nope", timeout=30)
        assert e.value.code == 404


@pytest.fixture(scope="module")
def progressive_server():
    session = RenderSession(default_world_source(), 24, 14,
                            Options(samples_per_pixel=1, max_ray_bounces=2),
                            device="cpu", progressive=True, max_samples=3)
    httpd, t, url = _serve(session)
    yield url
    _stop(httpd, t)


class TestProgressiveAccumulation:
    """/frame.png returns increasing-spp frames between moves; a camera
    move resets the accumulator."""

    def test_spp_increases_across_polls_and_resets_on_move(
            self, progressive_server):
        s = progressive_server
        _, h1, b1 = _get(s + "/frame.png")
        _, h2, b2 = _get(s + "/frame.png")
        _, h3, b3 = _get(s + "/frame.png")
        assert [h["X-Samples"] for h in (h1, h2, h3)] == ["1", "2", "3"]
        assert h1["X-Samples-Max"] == "3"
        # saturated: further polls stay at max and stop re-rendering
        _, h4, b4 = _get(s + "/frame.png")
        assert h4["X-Samples"] == "3" and b4 == b3
        # refinement actually changed pixels (new RNG streams per batch)
        assert b2 != b1
        # a camera move resets accumulation to the base spp
        _post(s + "/move", {"dx": 0.1, "dy": 0.0, "dz": 0.0})
        _, h5, _ = _get(s + "/frame.png")
        assert h5["X-Samples"] == "1"

    def test_first_batch_matches_plain_render(self):
        opts = Options(samples_per_pixel=2, max_ray_bounces=2)
        plain = RenderSession(default_world_source(), 20, 12, opts,
                              device="cpu")
        prog = RenderSession(default_world_source(), 20, 12, opts,
                             device="cpu", progressive=True, max_samples=4)
        np.testing.assert_array_equal(plain.frame(), prog.frame())
        assert prog.samples_accumulated == 2
        prog.frame()
        assert prog.samples_accumulated == 4

    def test_first_png_decodes_to_a_fresh_sessions_frame(self):
        opts = Options(samples_per_pixel=1, max_ray_bounces=2)
        kw = dict(device="cpu", progressive=True, max_samples=2)
        served = RenderSession(default_world_source(), 16, 9, opts, **kw)
        httpd, t, url = _serve(served)
        try:
            body = _get(url + "/frame.png")[2]
        finally:
            _stop(httpd, t)
        fresh = RenderSession(default_world_source(), 16, 9, opts, **kw)
        np.testing.assert_array_equal(png_rgba(body), fresh.frame())


class TestMeshSceneViewer:
    """An OBJ-scale mesh scene in the viewer rides the binned engine on the
    card (no silent fall back), with progressive refinement over a live
    socket."""

    def test_mesh_session_resolves_binned_and_refines(self):
        from raytracer_tpu_torch.models.builders import icosphere_mesh
        from raytracer_tpu_torch.scene import (DIFFUSE, METAL,
                                               build_materials, build_scene)
        tris = icosphere_mesh((0.0, 0.0, -1.2), 0.5, 0, 4)   # 5120 tris
        mats = build_materials([(DIFFUSE, (0.7, 0.3, 0.3), 0.0, 1.0),
                                (METAL, (0.8, 0.8, 0.8), 0.1, 1.0)])
        scene = build_scene([((0.0, -100.5, -1.0), 100.0, 1)], tris, mats,
                            exact_planes=True)
        cam = rtt.Camera.new_at((0.0, 0.0, 0.0), 1.77778)
        assert scene.num_triangles >= 2048
        opts = Options(samples_per_pixel=1, max_ray_bounces=2)
        # on the card auto-dispatch picks the binned per-bounce engine (K3)
        # for this scene and spp; on the CPU, K1's plain version
        card = RenderSession.from_world(scene, cam, 32, 18, opts,
                                        device="cuda", progressive=True,
                                        max_samples=3)
        assert card.resolved_engine() == "cuda_binned"
        session = RenderSession.from_world(scene, cam, 16, 9, opts,
                                           device="cpu", progressive=True,
                                           max_samples=3)
        assert session.resolved_engine() == "torch"

        httpd, t, base = _serve(session)
        try:
            _, h1, b1 = _get(base + "/frame.png")
            _, h2, b2 = _get(base + "/frame.png")
            assert [h["X-Samples"] for h in (h1, h2)] == ["1", "2"]
            assert b2 != b1          # frames actually refine
            _post(base + "/move", {"dx": 0.05, "dy": 0.0, "dz": 0.0})
            _, h3, _ = _get(base + "/frame.png")
            assert h3["X-Samples"] == "1"
        finally:
            _stop(httpd, t)
