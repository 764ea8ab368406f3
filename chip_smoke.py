"""Smoke test of the path tracer on one NVIDIA GPU (four with ``--four``).

Drives the main path through the library's own entry points and checks each
result against the repo's plain references. Phases (all in one process):

1. device   print the card's name and power limit; refuse anything but a GPU
2. compile  compile the 10_final render (1280x720, spp 64, depth 32) and
            print its memory analysis
3. intersect the main path's sphere scan (geometry.sphere.intersect_spheres,
            default matmul precision, as rendered) on the 10_final table,
            921,600 primary + 1,048,576 diffuse secondary rays, against the
            float64 oracle on 32,768 of them: t within 1e-5 relative, or
            within the f32 error bound where the quadratic is
            ill-conditioned; another answer only where f32 rounding decides
            it (geometry.sphere_f64.compare_hits)
4. render   render_persistent at full size (finite image, segment bounds,
            wall time, live Mrays/s), then render_persistent vs the plain
            wavefront.render (XLA hit path, HIGHEST precision) at spp 4 on
            the same RNG counters
5. mesh     the seeded IBL quad+sphere scene through the XLA BVH traversal
            vs its committed golden, and render_hybrid vs render_persistent
            segment counts
6. viewer   viewer/serve.py in a thread: three frames over localhost

``--four`` runs only the four-GPU path: render_persistent_multichip on a
(tile 2 x spp 2) mesh vs render_persistent on one GPU, same process, with
every image shard on its own device.

Prints one JSON object as the last line:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
and exits non-zero, printing no such line, if any phase fails or JAX finds
no GPU. ``--rehearse`` runs every phase on the CPU at a tiny size and
prints no result line.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs
"""

import argparse
import json
import os
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENE_SEED = 20230328


def log(msg):
    print(msg, flush=True)


class Sizes:
    """Full sizes on the GPU; tiny ones for a CPU rehearsal."""

    def __init__(self, rehearse):
        self.rehearse = rehearse
        self.res = (64, 36) if rehearse else (1280, 720)
        self.spp = 4 if rehearse else 64
        self.limit = 6 if rehearse else 32
        self.ref_spp = 2 if rehearse else 4
        self.scene_size = 2 if rehearse else 11
        self.secondary = 2048 if rehearse else 1 << 20
        self.oracle_rays = 1024 if rehearse else 1 << 15
        self.viewer = ((32, 16), 1, 2) if rehearse else ((640, 360), 8, 10)


def phase_compile(ctx):
    from learn_path_tracing_tpu.integrator.persistent import render_persistent

    sz = ctx["sizes"]
    lowered = render_persistent.lower(ctx["wd"], ctx["cp"], sz.res,
                                      spp=sz.spp, limit=sz.limit, seed=0)
    t0 = time.perf_counter()
    ctx["compiled"] = lowered.compile()
    log(f"compile: render_persistent {sz.res} spp {sz.spp} depth {sz.limit} "
        f"in {time.perf_counter() - t0:.2f} s")
    log(f"compile: memory_analysis {ctx['compiled'].memory_analysis()}")


def phase_intersect(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from learn_path_tracing_tpu.camera.camera import generate_rays
    from learn_path_tracing_tpu.geometry.sphere import intersect_spheres
    from learn_path_tracing_tpu.geometry.sphere_f64 import (compare_hits,
                                                            nearest_hit,
                                                            secondary_rays)

    sz, wd = ctx["sizes"], ctx["wd"]
    table = (wd.centers, wd.radii, wd.materials.transparency)
    scan = jax.jit(intersect_spheres)   # default precision, as rendered
    prim = generate_rays(ctx["cp"], sz.res, 0, 0, model="thinlens")
    t_p, i_p = scan(prim.ro, prim.rd, *table)
    ro2, rd2 = secondary_rays(np.asarray(prim.ro), np.asarray(prim.rd),
                              np.asarray(t_p), np.asarray(i_p),
                              *map(np.asarray, table[:2]), sz.secondary,
                              np.random.default_rng(7))
    rng = np.random.default_rng(8)
    ro = jnp.concatenate([prim.ro, jnp.asarray(ro2)])
    rd = jnp.concatenate([prim.rd, jnp.asarray(rd2)])
    t, idx = map(np.asarray, scan(ro, rd, *table))

    # the f64 oracle on a seeded subsample of the rays
    k = rng.choice(len(t), size=min(len(t), sz.oracle_rays), replace=False)
    ro_k, rd_k = np.asarray(ro)[k], np.asarray(rd)[k]
    t64, i64 = nearest_hit(ro_k, rd_k, *map(np.asarray, table))
    c = compare_hits(ro_k, rd_k, *table, t[k], idx[k], t64, i64,
                     round_oc=True)
    log(f"intersect: {len(t)} rays x {wd.radii.shape[0]} spheres; "
        f"{c['rays']} checked against the f64 oracle ({c['hits']} hits): "
        f"max rel dt {c['max_rel_dt']:.3e}, rays over 1e-5 "
        f"{c['over_rtol']}, hit/miss flips {c['hit_miss_flips']}, index "
        f"mismatches {c['index_mismatches']}, explained by f32 rounding "
        f"{c['explained_by_rounding']}, unexplained {c['unexplained']}")
    assert c["unexplained"] == 0, f"{c['unexplained']} unexplained rays"
    # rounding decides only tangent rays, ties and a few surface re-hits
    assert c["explained_by_rounding"] <= 0.01 * c["rays"], "too many flips"
    ms = _ms_per_call(scan, (ro, rd, *table))
    log(f"intersect: {ms:.3f} ms per call on {ctx['card']}")


def _ms_per_call(fn, args, iters=5):
    """Mean device-complete wall milliseconds per call, after a warm-up."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1e3


def phase_render(ctx):
    import jax
    import numpy as np

    from learn_path_tracing_tpu.integrator.persistent import render_persistent
    from learn_path_tracing_tpu.integrator.wavefront import render

    sz, wd, cp = ctx["sizes"], ctx["wd"], ctx["cp"]
    compiled = ctx["compiled"]
    jax.block_until_ready(compiled(wd, cp, seed=1))   # warm-up
    t0 = time.perf_counter()
    img, segs = jax.block_until_ready(compiled(wd, cp, seed=0))
    dt = time.perf_counter() - t0
    img, segs = np.asarray(img), float(segs)
    n = sz.res[0] * sz.res[1] * sz.spp
    assert img.shape == (*sz.res, 3) and np.isfinite(img).all(), "image"
    assert n <= segs <= n * sz.limit, f"segments {segs} outside [{n}, " \
        f"{n * sz.limit}]"
    log(f"render: 10_final {sz.res[0]}x{sz.res[1]} spp {sz.spp} depth "
        f"{sz.limit}: {dt:.3f} s wall, {segs:.0f} segments, "
        f"{segs / dt / 1e6:.2f} Mrays/s live on {ctx['card']}")

    res, spp = sz.res, sz.ref_spp
    a_img, a_seg = render_persistent(wd, cp, res, spp=spp, limit=sz.limit,
                                     seed=0)
    with jax.default_matmul_precision("highest"):
        b_img, b_seg = render(wd, cp, res, spp=spp, limit=sz.limit, seed=0,
                              hit_backend="xla")
    a_seg, b_seg = float(a_seg), float(b_seg)
    seg_rel = abs(a_seg - b_seg) / b_seg
    mad = float(np.mean(np.abs(np.asarray(a_img) - np.asarray(b_img))))
    log(f"render: vs wavefront.render (xla) spp {spp}: segments {a_seg:.0f} "
        f"vs {b_seg:.0f} (rel {seg_rel:.2e}), mean |d radiance| {mad:.3e}")
    assert seg_rel <= 1e-4, f"segment counts differ by {seg_rel:.2e}"
    assert mad <= 1e-3, f"mean |d radiance| {mad:.3e}"


def phase_mesh(ctx):
    import numpy as np

    from learn_path_tracing_tpu.core import image as image_io
    from learn_path_tracing_tpu.integrator.hybrid import render_hybrid
    from learn_path_tracing_tpu.integrator.persistent import render_persistent
    from learn_path_tracing_tpu.integrator.wavefront import render
    from learn_path_tracing_tpu.models import ibl_mesh_scene

    res = (64, 36)
    with tempfile.TemporaryDirectory() as tmp:
        lwd, cam = ibl_mesh_scene(os.path.join(tmp, "env.exr"), res)
    cp = cam.params()
    img, _ = render(lwd, cp, res, spp=4, limit=6, seed=3, bsdf="legacy",
                    scene="legacy")
    golden = image_io.read_png(os.path.join(
        ROOT, "tests", "goldens_self", "ibl_mesh_64x36_spp4_seed3.png"))
    ours = image_io.from_raster(image_io.to_raster(np.asarray(img) ** (1 / 2.2)))
    d = np.abs(ours - golden)
    log(f"mesh: IBL scene vs golden: mean |d| {d.mean() * 255:.3f}/255, "
        f"max {d.max() * 255:.3f}/255")
    assert d.mean() <= 0.5 / 255 and d.max() <= 2.0 / 255, "golden"

    kw = dict(spp=4, limit=6, seed=3, bsdf="legacy", scene="legacy",
              camera_model="thinlens")
    h_img, h_seg = render_hybrid(lwd, cp, res, **kw)
    p_img, p_seg = render_persistent(lwd, cp, res, **kw)
    mad = float(np.mean(np.abs(np.asarray(h_img) - np.asarray(p_img))))
    log(f"mesh: render_hybrid segments {float(h_seg):.0f} vs "
        f"render_persistent {float(p_seg):.0f}, mean |d| {mad:.2e}")
    assert float(h_seg) == float(p_seg), "hybrid/persistent segments differ"


def phase_viewer(ctx):
    import socket

    from learn_path_tracing_tpu.core.image import decode_png
    from learn_path_tracing_tpu.viewer import serve

    (w, h), spp, limit = ctx["sizes"].viewer
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = serve.parse_args(
        ["--scene", "spheres", "--width", str(w), "--height", str(h),
         "--spp", str(spp), "--limit", str(limit), "--port", str(port),
         "--frame-interval", "0.05"])
    stop = threading.Event()
    t = threading.Thread(target=serve.serve, args=(args, stop), daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    gens, deadline = [], time.time() + 600
    try:
        while len(gens) < 3 and time.time() < deadline and t.is_alive():
            try:
                t0 = time.perf_counter()
                with urllib.request.urlopen(base + "/frame.png",
                                            timeout=30) as r:
                    gen = int(r.headers["X-Gen"])
                    png = r.read()
                if not gens or gen > gens[-1]:
                    raster = decode_png(png)
                    assert raster.shape == (h, w, 3), raster.shape
                    gens.append(gen)
                    log(f"viewer: frame gen {gen} spp {r.headers['X-Spp']} "
                        f"({len(png)} bytes, request "
                        f"{(time.perf_counter() - t0) * 1e3:.1f} ms)")
                    continue
            except OSError:
                pass   # server not up yet, or no frame published yet
            time.sleep(0.1)
    finally:
        stop.set()
        t.join(timeout=120)
    assert len(gens) == 3, f"got {len(gens)} frames"


def phase_four(ctx):
    import jax
    import numpy as np

    from learn_path_tracing_tpu.integrator.persistent import render_persistent
    from learn_path_tracing_tpu.parallel import make_mesh
    from learn_path_tracing_tpu.parallel.mesh import render_persistent_multichip

    sz, wd, cp = ctx["sizes"], ctx["wd"], ctx["cp"]
    devices = jax.devices()
    assert len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}"
    mesh = make_mesh(n_tile=2, n_spp=2, devices=devices[:4])
    kw = dict(spp=sz.spp, limit=sz.limit, seed=0)
    jax.block_until_ready(render_persistent_multichip(
        wd, cp, sz.res, mesh=mesh, **dict(kw, seed=1)))   # compile
    t0 = time.perf_counter()
    m_img, m_seg = jax.block_until_ready(render_persistent_multichip(
        wd, cp, sz.res, mesh=mesh, **kw))
    dt4 = time.perf_counter() - t0
    shard_devs = sorted({s.device.id for s in m_img.addressable_shards})
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices[:4]]

    one = jax.device_put(wd, devices[0]), jax.device_put(cp, devices[0])
    jax.block_until_ready(render_persistent(*one, sz.res, **dict(kw, seed=1)))
    t0 = time.perf_counter()
    s_img, s_seg = jax.block_until_ready(render_persistent(*one, sz.res, **kw))
    dt1 = time.perf_counter() - t0
    m_img, s_img = np.asarray(m_img), np.asarray(s_img)
    diff = np.abs(m_img - s_img)
    log(f"four: (tile 2 x spp 2) on devices {shard_devs}: {dt4:.3f} s vs "
        f"{dt1:.3f} s on one device; segments {float(m_seg):.0f} vs "
        f"{float(s_seg):.0f}; max |d| {diff.max():.3e}, mean |d| "
        f"{diff.mean():.3e}; peak bytes per device {peaks}")
    assert len(shard_devs) == 4, f"image shards on devices {shard_devs}"
    # (the CPU reports no memory statistics)
    assert all(p is None or p > 0 for p in peaks), "a device did no work"
    # The sharded program has other shapes than the one-device program, so
    # the GPU compiler may contract other FMAs: a handful of ill-conditioned
    # rays (surface re-hits, grazing hits) then take another path. On the
    # CPU both are bit-identical per sample (tests/test_parallel.py); here
    # segment counts and the mean image agree to ~1e-6 (four H100s: 176 of
    # 1.56e8 segments, mean |d| 8e-7).
    seg_rel = abs(float(m_seg) - float(s_seg)) / float(s_seg)
    assert seg_rel <= 1e-5, f"segment counts differ by {seg_rel:.2e}"
    assert diff.mean() <= 1e-5, f"mean |d| {diff.mean():.3e}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-GPU sharded render and its "
                        "one-GPU comparison")
    p.add_argument("--rehearse", action="store_true",
                   help="run every phase on the CPU at a tiny size; "
                        "prints no result line")
    args = p.parse_args(argv)

    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
    from learn_path_tracing_tpu.utils.runtime import (card_info,
                                                      enable_compile_cache)

    card = card_info()
    log(card or "nvidia-smi: not available")
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        log(f"device: JAX found no GPU (platform {dev.platform!r}); "
            f"nothing run")
        return 1
    enable_compile_cache()
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")

    from learn_path_tracing_tpu.models import random_scene, stage10_camera

    sizes = Sizes(args.rehearse)
    ctx = {"sizes": sizes, "card": card or dev.device_kind,
           "wd": random_scene(size=sizes.scene_size, seed=SCENE_SEED).device(),
           "cp": stage10_camera(sizes.res).params()}
    if args.four:
        phases = [phase_four]
    else:
        phases = [phase_compile, phase_intersect, phase_render, phase_mesh,
                  phase_viewer]
    failed = []
    for phase in phases:
        name = phase.__name__[len("phase_"):]
        t0 = time.perf_counter()
        try:
            phase(ctx)
            log(f"PASS {name} ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            log(f"FAIL {name} ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)
            if name == "compile":
                break
    if failed:
        log(f"failed phases: {', '.join(failed)}")
        return 1
    if args.rehearse:
        log("rehearsal ok")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
