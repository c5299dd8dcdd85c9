"""Interactive terminal viewer — the platform/GUI layer (port of
``raytracer_tpu/viewer.py``).

The reference's L6 is a Swift/Cocoa app with a custom event loop: WASD/space/
shift keypresses move the camera and trigger a synchronous re-render that is
blitted to the window (``/root/reference/MacOSPlatform/MacOSPlatform/
GameView.swift:16-27,198-219,323-334``).  This terminal app is its
counterpart: the same key bindings drive ``move_camera_position`` over a
``RenderSession`` that renders on ``device`` (default ``cuda``: the CUDA
kernels, never a silent CPU fallback), and the framebuffer is blitted as
ANSI 24-bit half-block cells (two pixels per character cell).

Keys (GameView.swift:198-219): w/a/s/d move in x/z, space up, c down
(left-shift has no terminal keycode; 'c' substitutes), q quits,
+/- change samples per pixel.

Run: ``python -m raytracer_tpu_torch.viewer [scene=PATH] [width=N]
[samples=N] [device=cuda|cpu]``
"""

from __future__ import annotations

import dataclasses
import sys
import termios
import tty
from typing import Optional

import numpy as np

from .api import RenderSession
from .models import default_world_source
from .render import Options

# GameView.swift:198-212 movement step per keypress
STEP = 0.2


def framebuffer_to_ansi(fb: np.ndarray) -> str:
    """RGBA8 [H, W, 4] -> ANSI truecolor half-block string (2 rows/cell)."""
    h, w = fb.shape[:2]
    if h % 2:
        fb = fb[:-1]
        h -= 1
    out = []
    for y in range(0, h, 2):
        row = []
        top = fb[y]
        bot = fb[y + 1]
        for x in range(w):
            tr, tg, tb = int(top[x, 0]), int(top[x, 1]), int(top[x, 2])
            br, bg, bb = int(bot[x, 0]), int(bot[x, 1]), int(bot[x, 2])
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(row) + "\x1b[0m")
    return "\n".join(out)


def _read_key(fd) -> str:
    return sys.stdin.read(1)


def run_viewer(source: Optional[str] = None, width: int = 128,
               samples: int = 4, depth: int = 8, device: str = "cuda"
               ) -> None:
    source = source or default_world_source()
    height = max(2, int(width / 1.77778) // 2 * 2)
    session = RenderSession(source, width, height,
                            Options(samples_per_pixel=samples,
                                    max_ray_bounces=depth), device=device)

    if not sys.stdin.isatty():
        # non-interactive: render one frame and dump it (useful for tests)
        sys.stdout.write(framebuffer_to_ansi(session.frame()) + "\n")
        return

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            frame = session.frame()
            sys.stdout.write("\x1b[H\x1b[2J")      # clear
            sys.stdout.write(framebuffer_to_ansi(frame))
            sys.stdout.write(
                f"\n[wasd/space/c move  +/- spp({session.options.samples_per_pixel})"
                f"  q quit]  cam={np.round(np.asarray(session.handle.camera.position()), 2)}\n")
            sys.stdout.flush()
            key = _read_key(fd)
            # GameView.swift:198-219 bindings
            if key == "q":
                break
            elif key == "a":
                session.move_camera(-STEP, 0.0, 0.0)
            elif key == "d":
                session.move_camera(STEP, 0.0, 0.0)
            elif key == "w":
                session.move_camera(0.0, 0.0, -STEP)
            elif key == "s":
                session.move_camera(0.0, 0.0, STEP)
            elif key == " ":
                session.move_camera(0.0, STEP, 0.0)
            elif key == "c":
                session.move_camera(0.0, -STEP, 0.0)
            elif key in ("+", "-"):
                spp = session.options.samples_per_pixel
                session.options = dataclasses.replace(
                    session.options, samples_per_pixel=spp * 2
                    if key == "+" else max(1, spp // 2))
                session._dirty = True
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kwargs = {}
    for a in argv:
        if a.startswith("scene="):
            with open(a[6:]) as f:
                kwargs["source"] = f.read()
        elif a.startswith("width="):
            kwargs["width"] = int(a[6:])
        elif a.startswith("samples="):
            kwargs["samples"] = int(a[8:])
        elif a.startswith("device="):
            kwargs["device"] = a[7:]
        else:
            raise SystemExit(f"Unknown argument '{a}'")
    run_viewer(**kwargs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
