"""Interactive viewer — the reference's keyboard shell, in a terminal (the
port of ``raytpu/cli/interactive.py``).

The reference is an interactive XNA app (Game1.cs:227-328): WASD+arrow
camera, a GPU-rasterized live preview of the scene, Enter kicks off a
trace, Space toggles between the preview and the traced image, and a
percent overlay tracks progress (Game1.cs:331-344, :389-416).

This is the batch framework's equivalent for a terminal:

- the "rasterized preview" is a FAST low-resolution trace (primary rays
  only, no shadows/recursion — one walk pass) redrawn after every
  camera move;
- ``Enter`` runs the full-quality trace progressively (tile batches fill
  the image in, like watching the reference's RenderTarget);
- ``Space`` toggles preview / traced view, ``n`` cycles the diagnostic
  render modes (shaded → normals → convex), ``q``/``Esc`` quits;
- frames draw as 24-bit-color ANSI half-blocks (two pixels per character
  cell), so it runs over ssh with no GUI stack.

The state machine (`InteractiveSession`) is pure — keys in, images out —
and fully testable without a terminal; ``run_interactive`` adds the raw-TTY
loop around it.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional

import numpy as np

from raytpu_torch.config import RenderConfig, RenderMode
from raytpu_torch.io.image import to_uint8
from raytpu_torch.render.wavefront import render_image

#: Key bindings (Game1.cs:236-287 analog).
HELP = """\
 w/s      dolly forward / back        a/d or ←/→  orbit left / right
 r/f or ↑/↓  rise / sink              +/-   zoom (fov)
 j/k      spin first object (N/M)     Enter full-quality trace
 Space    toggle preview / traced     n     cycle shaded/normals/convex
 h        help                        q / Esc  quit
"""

#: CSI final bytes → the equivalent letter command (arrow-key orbit,
#: Game1.cs arrows).
_CSI_KEYS = {"A": "r", "B": "f", "C": "d", "D": "a"}


def _read_key(stdin) -> str:
    """One logical key: decodes ESC [ X arrow sequences (a bare ESC —
    nothing following within 50 ms — stays ESC = quit).

    Reads bytes with ``os.read`` on the raw fd: buffered ``file.read``
    would swallow the bracket byte into Python's buffer and make the
    ``select`` probe miss it."""
    import os as _os
    import select

    fd = stdin.fileno()
    rd = lambda: _os.read(fd, 1).decode(errors="ignore")
    ch = rd()
    if ch != "\x1b":
        return ch
    if not select.select([fd], [], [], 0.05)[0]:
        return ch  # bare Escape
    nxt = rd()
    if nxt != "[":
        return ch
    fin = rd()
    return _CSI_KEYS.get(fin, "")  # unknown CSI -> noop


def ansi_image(img: np.ndarray, max_cols: int = 100) -> str:
    """(H, W, 3) float [0,1] or uint8 → ANSI truecolor half-block text.

    Each character cell shows two vertical pixels ('▀' with the top pixel
    as foreground, bottom as background)."""
    arr = to_uint8(img)
    h, w = arr.shape[:2]
    step = max(1, -(-w // max_cols))
    arr = arr[::step, ::step]
    if arr.shape[0] % 2:
        arr = np.concatenate([arr, np.zeros((1,) + arr.shape[1:], np.uint8)])
    top = arr[0::2]
    bot = arr[1::2]
    lines = []
    for tr, br in zip(top, bot):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(tr, br)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class InteractiveSession:
    """Pure interactive state machine: ``handle_key`` in, images out.

    Camera orbits its target (the reference moves the camera with WASD and
    rebuilds the view each frame, Game1.cs:236-268)."""

    def __init__(self, flat_scene, cfg: RenderConfig,
                 preview_res: int = 96, move_step: float = 2.0,
                 orbit_step: float = 0.15, host_scene=None,
                 flatten_kwargs: Optional[dict] = None):
        self.scene = flat_scene
        #: Host-side Scene (pre-flatten): enables object rotation (j/k —
        #: the reference's N/M keys, Game1.cs:270-287) by re-baking, with
        #: ``flatten_kwargs`` on the scene's device unless they name one.
        self.host_scene = host_scene
        self.flatten_kwargs = flatten_kwargs or {}
        self.cfg = cfg
        self.preview_res = preview_res
        self.move_step = move_step
        self.orbit_step = orbit_step
        self.target = np.asarray((0.0, 0.0, 0.0), np.float32)
        self.radius = 35.0
        self.yaw = 0.0
        self.pitch = 0.45
        self.fov = math.pi / 4
        self.showing_trace = False
        self.traced: Optional[np.ndarray] = None
        self.mode = RenderMode.SHADED

    # -- camera -------------------------------------------------------------
    def camera(self, aspect: float = 1.0):
        from raytpu_torch.core.camera import Camera

        cp = math.cos(self.pitch)
        pos = self.target + self.radius * np.asarray(
            [math.sin(self.yaw) * cp, math.sin(self.pitch),
             math.cos(self.yaw) * cp], np.float32)
        return Camera(position=tuple(pos), target=tuple(self.target),
                      fov=self.fov, aspect=aspect)

    # -- rendering ----------------------------------------------------------
    def _preview_cfg(self) -> RenderConfig:
        return dataclasses.replace(
            self.cfg, width=self.preview_res, height=self.preview_res,
            max_reflections=0, use_multisampling=False,
            render_mode=self.mode,
            tile_pixels=self.preview_res * self.preview_res,
        )

    def render_preview(self) -> np.ndarray:
        """The live low-res view (the rasterized-preview analog)."""
        img = render_image(self.scene, self._preview_cfg(), self.camera())
        return img.cpu().numpy()

    def render_full(self, progress=None, watch=None) -> np.ndarray:
        """Enter: the full-quality trace (progressive via callbacks)."""
        cfg = dataclasses.replace(self.cfg, render_mode=self.mode)
        img = render_image(self.scene, cfg, self.camera(cfg.width / cfg.height),
                           progress=progress).cpu().numpy()
        self.traced = img
        self.showing_trace = True
        return img

    # -- input --------------------------------------------------------------
    def handle_key(self, key: str) -> str:
        """Apply one key; returns the action taken:
        'move' (preview is stale), 'trace', 'toggle', 'mode', 'help',
        'quit' or 'noop'."""
        k = key.lower()
        if k in ("q", "\x1b"):
            return "quit"
        if key == "\r" or key == "\n":
            return "trace"
        if key == " ":
            if self.traced is not None:
                self.showing_trace = not self.showing_trace
                return "toggle"
            return "noop"
        if k == "n":
            order = [RenderMode.SHADED, RenderMode.NORMALS,
                     RenderMode.CONVEXFLAG]
            self.mode = order[(order.index(self.mode) + 1) % 3]
            return "mode"
        if k == "h":
            return "help"
        if k in ("j", "k"):
            # Rotate the first object about Y and re-bake (the reference's
            # N/M object spin, Game1.cs:270-287).  Needs the host scene.
            if self.host_scene is None or not self.host_scene.objects:
                return "noop"
            obj = self.host_scene.objects[0]
            rx, ry, rz = obj.rotation
            obj.rotation = (rx, ry + (self.orbit_step
                                      if k == "j" else -self.orbit_step), rz)
            self.scene = self.host_scene.flatten(
                **{"device": self.scene.device, **self.flatten_kwargs})
            self.showing_trace = False
            return "move"
        moves = {
            "w": ("radius", -self.move_step),
            "s": ("radius", +self.move_step),
            "a": ("yaw", -self.orbit_step),
            "d": ("yaw", +self.orbit_step),
            "r": ("pitch", +self.orbit_step * 0.6),
            "f": ("pitch", -self.orbit_step * 0.6),
            "+": ("fov", -0.05),
            "-": ("fov", +0.05),
        }
        if k in moves:
            attr, delta = moves[k]
            val = getattr(self, attr) + delta
            if attr == "radius":
                val = max(2.0, val)
            elif attr == "pitch":
                val = min(max(val, -1.4), 1.4)
            elif attr == "fov":
                val = min(max(val, 0.15), 2.6)
            setattr(self, attr, val)
            self.showing_trace = False
            return "move"
        return "noop"

    def current_image(self) -> np.ndarray:
        if self.showing_trace and self.traced is not None:
            return self.traced
        return self.render_preview()


def run_interactive(flat_scene, cfg: RenderConfig, out=sys.stdout,
                    max_cols: int = 100, host_scene=None,
                    flatten_kwargs=None) -> None:
    """Raw-TTY loop around InteractiveSession (the Game1 update loop)."""
    import termios
    import tty

    sess = InteractiveSession(flat_scene, cfg, host_scene=host_scene,
                              flatten_kwargs=flatten_kwargs)

    def draw(img, status=""):
        out.write("\x1b[2J\x1b[H")  # clear + home
        out.write(ansi_image(img, max_cols=max_cols) + "\n")
        out.write(status + "\n")
        out.flush()

    draw(sess.render_preview(),
         "raytpu interactive — h for help  (preview; Enter traces)")
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            key = _read_key(sys.stdin)
            action = sess.handle_key(key)
            if action == "quit":
                break
            if action == "help":
                out.write("\n" + HELP)
                out.flush()
                continue
            if action == "trace":
                def progress(done, total):
                    out.write(f"\rtracing {100.0 * done / total:6.2f} %")
                    out.flush()

                img = sess.render_full(progress=progress)
                draw(img, f"traced {img.shape[1]}x{img.shape[0]} — "
                          "Space toggles preview")
            elif action in ("move", "mode", "toggle"):
                draw(sess.current_image(),
                     f"mode={sess.mode.name.lower()}  yaw={sess.yaw:+.2f} "
                     f"pitch={sess.pitch:+.2f} r={sess.radius:.1f} "
                     "(Enter traces, q quits)")
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
