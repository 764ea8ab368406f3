"""Loopback tests for the HTTP viewer (viewer/serve.py) — the headless analog
of the reference's ti.GUI free-fly loop (12_free_view.py:557-579)."""

import json
import queue
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from learn_path_tracing_tpu.viewer.serve import (
    ViewerState,
    _apply_inputs,
    _encode_png,
    _make_handler,
)


@pytest.fixture
def server():
    state = ViewerState()
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(state))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield state, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _get(url):
    try:
        r = urllib.request.urlopen(url, timeout=10)
        return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), b""


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        r = urllib.request.urlopen(req, timeout=10)
        return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_page_and_frame_lifecycle(server):
    state, base = server
    status, _, body = _get(base + "/")
    assert status == 200 and b"learn_path_tracing_tpu viewer" in body

    # no frame published yet
    status, _, _ = _get(base + "/frame.png")
    assert status == 503

    png = _encode_png(np.full((8, 4, 3), 0.5, np.float32))
    state.publish(png, spp=16, pass_ms=12.0)
    status, headers, body = _get(base + "/frame.png")
    assert status == 200
    assert headers["X-Gen"] == "1" and headers["X-Spp"] == "16"
    assert body == png and body[:4] == b"\x89PNG"

    # progressive restart bumps the generation counter the page polls on
    state.publish(png, spp=16, pass_ms=10.0)
    _, headers, _ = _get(base + "/frame.png")
    assert headers["X-Gen"] == "2"


def test_input_post_enqueues(server):
    state, base = server
    assert _post(base + "/input", json.dumps({"move": "w"}).encode()) == 204
    assert state.inputs.get_nowait() == {"move": "w"}
    # malformed JSON is dropped, not an error (a browser mid-drag can
    # truncate); unknown paths 404
    assert _post(base + "/input", b"{oops") == 204
    assert state.inputs.empty()
    assert _post(base + "/nope", b"{}") == 404


def test_apply_inputs_moves_camera():
    from learn_path_tracing_tpu.camera import LegacyCamera

    cam = LegacyCamera((8, 4))
    cam.set_position((0.0, 0.0, 5.0))
    cam.look_at((0.0, 0.0, 0.0))
    p0 = np.array(cam.position)

    q = queue.Queue()
    assert _apply_inputs(cam, q, velocity=1.0) is False  # empty queue

    for ev in ({"move": "w"}, {"move": "d"}, {"move": "space"},
               {"rotate": [10.0, 5.0]}):
        q.put(ev)
    assert _apply_inputs(cam, q, velocity=1.0) is True
    p1 = np.array(cam.position)
    assert not np.allclose(p0, p1)
    assert p1[1] > p0[1]            # space moved up
    assert q.empty()


@pytest.mark.slow
def test_viewer_end_to_end_subprocess(tmp_path):
    """Full loop: subprocess serves frames from a real (tiny) render;
    generation advances across frames and input POSTs are accepted."""
    import os
    import socket
    import subprocess
    import time

    import jax

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    # The subprocess is a fresh interpreter: it must (a) run on CPU, and
    # (b) see the same persistent compile cache as the test process — a cold CPU compile of
    # even the tiny scene is compile-roulette against the test deadline.
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    cache_dir = jax.config.jax_compilation_cache_dir
    if cache_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = cache_dir
        env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "1"

    proc = subprocess.Popen(
        [sys.executable, "-m", "learn_path_tracing_tpu.viewer.serve",
         "--platform", "cpu", "--scene", "spheres", "--scene-size", "1",
         "--width", "32", "--height", "16", "--spp", "1", "--limit", "2",
         "--max-frames", "2000", "--frame-interval", "0.1",
         "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
    base = f"http://127.0.0.1:{port}"
    try:
        gens = []
        deadline = time.time() + 600
        while time.time() < deadline and len(gens) < 2:
            if proc.poll() is not None:
                out = proc.stdout.read().decode(errors="replace")
                raise AssertionError(
                    f"viewer subprocess exited early (rc={proc.returncode}, "
                    f"gens={gens}):\n{out}")
            try:
                status, headers, _ = _get(base + "/frame.png")
            except OSError:
                time.sleep(0.5)
                continue
            if status == 200:
                g = int(headers["X-Gen"])
                if not gens or g > gens[-1]:
                    gens.append(g)
                    if len(gens) == 1:
                        assert _post(base + "/input",
                                     b'{"rotate": [5, 0]}') == 204
            time.sleep(0.2)
        assert len(gens) >= 2, f"no frame progression (gens={gens})"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_progressive_preview_mode():
    """With preview_spp set, moved frames render at (preview_spp,
    preview_limit) and do NOT feed the quality accumulator: the first still
    frame restarts clean accumulation, and subsequent still frames
    accumulate. Sample values must match a preview-off renderer once
    still (counter-based RNG ⇒ bit-identical accumulators)."""
    import jax.numpy as jnp

    from learn_path_tracing_tpu.camera import Camera
    from learn_path_tracing_tpu.models import random_scene
    from learn_path_tracing_tpu.viewer.progressive import ProgressiveRenderer

    res = (16, 12)
    wd = random_scene(seed=5, size=1).device()
    cam = Camera(res, fov=40)
    cam.set_position((0, 1.5, 6))
    cam.look_at((0, 0, 0))

    def mk(preview):
        c = Camera(res, fov=40)
        c.set_position((0, 1.5, 6))
        c.look_at((0, 0, 0))
        return ProgressiveRenderer(
            wd, c, res, spp_per_frame=2, limit=3, seed=0, bsdf="modern",
            scene="spheres", preview_spp=preview, preview_limit=2)

    pv, full = mk(4), mk(0)

    f = pv.render(moved=True)          # preview frame
    assert pv.spp == 4 and pv._preview_only
    assert np.isfinite(np.asarray(f)).all()

    pv.render(moved=False)             # first still: restart at full quality
    full.render(moved=True)
    assert pv.spp == 2 and not pv._preview_only
    np.testing.assert_array_equal(np.asarray(pv.acc), np.asarray(full.acc))

    pv.render(moved=False)             # accumulation continues
    full.render(moved=False)
    assert pv.spp == 4
    np.testing.assert_array_equal(np.asarray(pv.acc), np.asarray(full.acc))
