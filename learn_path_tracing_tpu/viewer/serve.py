"""Live progressive viewer over HTTP — the headless analog of the reference's
``ti.GUI`` free-fly loop (/root/reference/legacy/PT_in_one_weekend/
12_free_view.py:557-579 and the mouse-look variant 14_mesh.py:1029-1062).

There is no window on a headless GPU host, so the interactive surface is a tiny
stdlib HTTP server: the render loop runs in the main thread (progressive
accumulation, movement-aware restart), a browser page polls ``/frame.png``
and posts WASD/mouse-look input to ``/input``. No external dependencies.

    python -m learn_path_tracing_tpu.viewer.serve --scene spheres
    python -m learn_path_tracing_tpu.viewer.serve --scene demo --port 8413
    # then open http://localhost:8413/

Controls (matching 12_free_view.py:559-574): W/A/S/D move, Space up,
Shift down, mouse drag to look (pitch clamped, 14_mesh.py:413-418).
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><title>learn_path_tracing_tpu viewer</title><style>
 body { background:#111; color:#ccc; font-family:monospace; text-align:center }
 canvas { image-rendering:pixelated; margin-top:12px; cursor:crosshair }
 #hud { margin-top:8px }
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">connecting…</div>
<div>W/A/S/D move · Space up · Shift down · drag to look</div>
<script>
const cv = document.getElementById('c'), hud = document.getElementById('hud');
const ctx = cv.getContext('2d');
let dragging = false, px = 0, py = 0, gen = -1;
function send(ev) { fetch('/input', {method:'POST', body: JSON.stringify(ev)}); }
window.addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if ('wasd '.includes(k)) { send({move: k === ' ' ? 'space' : k}); e.preventDefault(); }
  if (k === 'shift') send({move: 'shift'});
});
cv.addEventListener('mousedown', e => { dragging = true; px = e.clientX; py = e.clientY; });
window.addEventListener('mouseup', () => dragging = false);
window.addEventListener('mousemove', e => {
  if (!dragging) return;
  send({rotate: [(e.clientX - px) * 0.25, (py - e.clientY) * 0.25]});
  px = e.clientX; py = e.clientY;
});
async function tick() {
  try {
    const r = await fetch('/frame.png?g=' + gen, {cache: 'no-store'});
    gen = parseInt(r.headers.get('X-Gen'));
    hud.textContent = 'spp ' + r.headers.get('X-Spp') + ' · pass ' +
      r.headers.get('X-Pass-Ms') + ' ms';
    const blob = await r.blob();
    const img = await createImageBitmap(blob);
    cv.width = img.width; cv.height = img.height;
    ctx.drawImage(img, 0, 0);
  } catch (e) { hud.textContent = 'disconnected'; }
  setTimeout(tick, 100);
}
tick();
</script></body></html>"""


class ViewerState:
    """Shared between the HTTP threads and the render loop."""

    def __init__(self):
        self.inputs: queue.Queue = queue.Queue()
        self.lock = threading.Lock()
        self.png: bytes = b""
        self.gen = 0
        self.spp = 0
        self.pass_ms = 0.0

    def publish(self, png: bytes, spp: int, pass_ms: float):
        with self.lock:
            self.png = png
            self.gen += 1
            self.spp = spp
            self.pass_ms = pass_ms

    def snapshot(self):
        with self.lock:
            return self.png, self.gen, self.spp, self.pass_ms


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path.startswith("/frame.png"):
                png, gen, spp, ms = state.snapshot()
                if not png:
                    self.send_response(503)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("X-Gen", str(gen))
                self.send_header("X-Spp", str(spp))
                self.send_header("X-Pass-Ms", f"{ms:.0f}")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
            else:
                body = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        def do_POST(self):
            if self.path != "/input":
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                ev = json.loads(self.rfile.read(length) or b"{}")
                state.inputs.put(ev)
            except json.JSONDecodeError:
                pass
            self.send_response(204)
            self.end_headers()

    return Handler


def _apply_inputs(camera, inputs: queue.Queue, velocity: float) -> bool:
    """Drain queued input events onto the camera; True if it moved
    (12_free_view.py:559-574 key map)."""
    moved = False
    while True:
        try:
            ev = inputs.get_nowait()
        except queue.Empty:
            return moved
        mv = ev.get("move")
        if mv == "w":
            camera.move_front(velocity)
        elif mv == "s":
            camera.move_front(-velocity)
        elif mv == "a":
            camera.move_right(-velocity)
        elif mv == "d":
            camera.move_right(velocity)
        elif mv == "space":
            camera.move_up(velocity)
        elif mv == "shift":
            camera.move_up(-velocity)
        rot = ev.get("rotate")
        if rot:
            camera.rotate(float(rot[0]), float(rot[1]))
        moved = True


def _encode_png(frame) -> bytes:
    from ..core.image import encode_png, to_raster

    return encode_png(to_raster(frame))


def build_scene(name: str, res, asset_root=None, size: int = 11):
    """Returns (world_data, camera, bsdf, scene_kind, hit_backend).

    ``size``: grid half-extent of the 'spheres' scene (reference default 11
    → ~490 spheres, 10_final/__main__.py:12-45); tests pass 1 for a
    compile-cheap ~10-sphere world."""
    from ..camera import LegacyCamera

    if name == "spheres":
        from ..stages.l11_bvh import legacy_random_scene

        world = legacy_random_scene(size=size)
        # hit_backend 'auto' (the sphere scan); the BVH is built so
        # --hit-backend bvh can be compared against it
        wd = world.device(use_bvh=True)
        cam = LegacyCamera(res)
        cam.set_fov(20)
        cam.set_position((13, 2, 3))
        cam.look_at((0, 0, 0))
        return wd, cam, "legacy", "spheres", "auto"

    # mesh world: a name like 'demo'/'Yoimiya' or a .world.npy path
    import os as _os

    from ..scene.legacy_world import LegacyWorld
    from ..stages.legacy_common import make_asset_path_map

    path = name if name.endswith(".npy") else \
        f"/root/reference/legacy/{name}.world.npy"
    world = LegacyWorld()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = world.load(path, path_map=make_asset_path_map(asset_root))
    cam = LegacyCamera(res)
    cam.set_fov(30)
    if _os.path.basename(path).startswith("demo"):
        cam.set_position((0, 2, 8))
        cam.look_at((0, 0, 0))
    else:
        cam.set_position((0, 8, -30))
        cam.look_at((0, 8, 0))
    return wd, cam, "legacy", "legacy", "auto"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", type=str, default="spheres",
                   help="'spheres' | world name (demo/Yoimiya/...) | path")
    p.add_argument("--scene-size", type=int, default=11,
                   help="sphere-scene grid half-extent (11 = the reference "
                        "cover scene; tests use 1 for a tiny world)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=16, help="samples per pass")
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--port", type=int, default=8413)
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address; the server is unauthenticated, so "
                        "pass 0.0.0.0 only to deliberately expose it")
    p.add_argument("--velocity", type=float, default=1.0)
    p.add_argument("--preview-spp", type=int, default=-1,
                   help="motion-preview samples per frame (0 disables; "
                        "-1 auto: 4 for mesh scenes whose full pass is "
                        "below interactive rate, off for sphere scenes)")
    p.add_argument("--preview-limit", type=int, default=2,
                   help="motion-preview bounce limit (2 = first hit + env)")
    p.add_argument("--platform", type=str, default=None)
    p.add_argument("--max-frames", type=int, default=0,
                   help="stop after N frames (0 = run until interrupted)")
    p.add_argument("--frame-interval", type=float, default=0.0,
                   help="minimum seconds between published frames (paces "
                        "the loop so tiny renders don't spin; tests rely "
                        "on it to observe frame progression)")
    return p.parse_args(argv)


def serve(args, stop: threading.Event | None = None) -> int:
    """Run the viewer until ``--max-frames``, an interrupt, or ``stop``.
    Returns the number of frames published. Callable from a thread (the
    HTTP server runs in its own daemon thread either way)."""
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from ..utils.runtime import enable_compile_cache
    from .progressive import ProgressiveRenderer

    enable_compile_cache()

    res = (args.width, args.height)
    wd, cam, bsdf, scene_kind, hit_backend = build_scene(
        args.scene, res, size=args.scene_size)
    preview_spp = args.preview_spp
    if preview_spp < 0:
        # auto: mesh worlds need the cheap motion path (full mesh pass is
        # below interactive rate); the sphere scene free-flies at full spp
        preview_spp = 4 if args.scene != "spheres" else 0
    pr = ProgressiveRenderer(wd, cam, res, spp_per_frame=args.spp,
                             limit=args.limit, bsdf=bsdf, scene=scene_kind,
                             hit_backend=hit_backend,
                             preview_spp=preview_spp,
                             preview_limit=args.preview_limit)

    state = ViewerState()
    server = ThreadingHTTPServer((args.host, args.port),
                                 _make_handler(state))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"viewer: http://localhost:{args.port}/  (scene={args.scene})",
          flush=True)

    frames = 0
    moved = True
    try:
        while stop is None or not stop.is_set():
            t0 = time.time()
            frame = pr.render(moved=moved)
            png = _encode_png(frame)
            state.publish(png, pr.spp, (time.time() - t0) * 1e3)
            frames += 1
            if args.max_frames and frames >= args.max_frames:
                break
            if args.frame_interval:
                dt = args.frame_interval - (time.time() - t0)
                if dt > 0:
                    time.sleep(dt)
            moved = _apply_inputs(cam, state.inputs, args.velocity)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
    return frames


def main():
    serve(parse_args())


if __name__ == "__main__":
    main()
