"""Browser-based interactive viewer: the windowed-GUI analog (port of
``raytracer_tpu/httpviewer.py``).

The reference's L6 is a Cocoa app with a live framebuffer blit and
keyboard camera control (/root/reference/MacOSPlatform/MacOSPlatform/
GameView.swift:112-219, Framebuffer.swift:12-41).  This environment has no
display server, so the windowed frontend is a tiny dependency-free HTTP
server instead: the browser shows the framebuffer as a PNG and forwards
the SAME key bindings (GameView.swift:198-219 — a/d: x, w/s: z, space: up,
shift: down) to ``move_camera_position``; each move triggers a dirty-flag
re-render exactly like ``updateFramebufferIfDirty``
(GameView.swift:323-334), served on the next frame poll.  The session
renders on ``device`` (default ``cuda``: each poll of a progressive
default-world session is one launch of the CUDA kernel K1).

Run:  python -m raytracer_tpu_torch.httpviewer [scene=PATH] [port=N]
      [width=N] [samples=N] [ray_depth=N] [device=cuda|cpu]
then open http://localhost:8000/.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import urlparse

from .api import RenderSession
from .image import png_bytes
from .models import default_world_source
from .render import Options

# GameView.swift:198-219 moves 0.1 per keypress
STEP = 0.1

_PAGE = """<!doctype html>
<html><head><title>raytracer_tpu_torch</title><style>
 body { background:#111; color:#ccc; font-family:monospace; text-align:center }
 img  { image-rendering:pixelated; width:70vw; margin-top:2em }
</style></head><body>
<div>raytracer_tpu_torch &mdash; a/d: x &nbsp; w/s: z &nbsp; space: up &nbsp;
shift: down &nbsp; (<span id="stat">loading</span>)</div>
<img id="fb" alt="framebuffer">
<script>
const KEYS = {"a":[-STEP,0,0], "d":[STEP,0,0], "w":[0,0,-STEP],
              "s":[0,0,STEP], " ":[0,STEP,0], "Shift":[0,-STEP,0]};
let gen = 0, busy = false, timer = null;
async function refresh() {
  if (busy) return;
  busy = true;
  const t0 = performance.now();
  const r = await fetch("/frame.png?g=" + gen + "&s=" + Date.now());
  const blob = await r.blob();
  document.getElementById("fb").src = URL.createObjectURL(blob);
  const spp = r.headers.get("X-Samples");
  const sppMax = r.headers.get("X-Samples-Max");
  document.getElementById("stat").textContent =
      (performance.now() - t0).toFixed(0) + " ms/frame, gen " +
      r.headers.get("X-Generation") + ", " + spp + "/" + sppMax + " spp";
  busy = false;
  // progressive refinement: keep polling until the accumulator is full
  if (timer) clearTimeout(timer);
  if (parseInt(spp) < parseInt(sppMax))
    timer = setTimeout(refresh, 150);
}
document.addEventListener("keydown", async (e) => {
  const d = KEYS[e.key];
  if (!d) return;
  e.preventDefault();
  await fetch("/move", {method: "POST", body: JSON.stringify(
      {dx: d[0], dy: d[1], dz: d[2]})});
  gen += 1;
  refresh();
});
refresh();
</script></body></html>""".replace("STEP", str(STEP))


class ViewerHandler(BaseHTTPRequestHandler):
    session: RenderSession  # set by serve()
    lock: threading.Lock
    generation = 0

    def _send(self, code, ctype, body, headers=()):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Cache-Control", "no-store")
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/":
            self._send(200, "text/html; charset=utf-8", _PAGE.encode())
        elif path == "/frame.png":
            with self.lock:
                fb = self.session.frame()
                gen = type(self).generation
                spp = self.session.samples_accumulated
                spp_max = (self.session.max_samples
                           if self.session.progressive else spp)
            self._send(200, "image/png", png_bytes(fb),
                       headers=[("X-Generation", str(gen)),
                                ("X-Samples", str(spp)),
                                ("X-Samples-Max", str(spp_max))])
        elif path == "/camera":
            with self.lock:
                pos = [float(v) for v in self.session.handle.camera.origin]
            self._send(200, "application/json",
                       json.dumps({"origin": pos}).encode())
        else:
            self._send(404, "text/plain", b"not found")

    def do_POST(self):
        path = urlparse(self.path).path
        if path != "/move":
            self._send(404, "text/plain", b"not found")
            return
        n = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(n) or b"{}")
            dx = float(body.get("dx", 0.0))
            dy = float(body.get("dy", 0.0))
            dz = float(body.get("dz", 0.0))
        except (ValueError, json.JSONDecodeError):
            self._send(400, "text/plain", b"bad move body")
            return
        with self.lock:
            self.session.move_camera(dx, dy, dz)
            # per-server counter: the BoundHandler subclass (make_server)
            # owns its own `generation`, so two viewers in one process (or a
            # restarted test server) don't see each other's counts
            type(self).generation += 1
            gen = type(self).generation
        self._send(200, "application/json",
                   json.dumps({"generation": gen}).encode())

    def log_message(self, *args):  # quiet
        pass


def make_server(session: RenderSession, port: int = 8000) -> HTTPServer:
    handler = type("BoundHandler", (ViewerHandler,), {
        "session": session, "lock": threading.Lock(), "generation": 0})
    return HTTPServer(("127.0.0.1", port), handler)


def serve(source: str | None = None, *, width: int = 400, port: int = 8000,
          samples: int = 16, ray_depth: int = 8,
          progressive: bool = True, device: str = "cuda",
          session: RenderSession | None = None) -> None:
    if session is None:
        src = source if source is not None else default_world_source()
        aspect = 1.77778
        session = RenderSession(
            src, width, int(width / aspect),
            Options(samples_per_pixel=samples, max_ray_bounces=ray_depth),
            device=device, progressive=progressive)
    httpd = make_server(session, port)
    print(f"viewer on http://localhost:{port}/  (ctrl-c to stop)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


def main(argv=None) -> int:
    import sys
    argv = sys.argv[1:] if argv is None else argv
    kw = {}
    src = None
    for a in argv:
        k, _, v = a.partition("=")
        if k == "scene":
            with open(v) as f:
                src = f.read()
        elif k in ("port", "width", "samples", "ray_depth"):
            kw[k] = int(v)
        elif k == "device":
            kw[k] = v
        else:
            raise SystemExit(f"Unknown argument '{a}'")
    serve(src, **kw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
