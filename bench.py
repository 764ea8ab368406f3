"""Headline benchmark: the 10_final cover scene on one GPU.

Prints one JSON line per measurement:
  {"metric": ..., "value": N, "unit": ..., "device": {...}}

- Workload: the reference's stage-10 scene (~490 spheres, mixed BSDFs) at
  1280x720, depth 32 (10_final/__main__.py:50-52), measured over `--spp`
  samples after a warm-up run that compiles.
- value: millions of *live* ray segments traced per second (dead/masked
  lanes are not counted, so this is useful-work throughput), or wall
  seconds for the fixed-work modes.
- device: platform, device kind and count as JAX reports them, and the
  card's name and power limit from nvidia-smi. Timing ends in
  ``jax.block_until_ready``.
"""

import argparse
import json
import sys
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--limit", type=int, default=32)
    p.add_argument("--iters", type=int, default=3,
                   help="timed renders after the warm-up")
    p.add_argument("--trace", type=str, default="",
                   help="also write a jax.profiler trace of one more "
                        "render to this directory (after the timed ones)")
    p.add_argument("--platform", type=str, default=None,
                   help="force a JAX platform (cpu for rehearsals)")
    p.add_argument("--hit-backend", type=str, default="auto",
                   choices=["auto", "xla", "bvh"])
    p.add_argument("--pool-mult", type=int, default=0,
                   help="persistent pool multiplier override (0 = auto)")
    p.add_argument("--pool-div", type=int, default=0,
                   help="persistent pool divisor override (0 = auto); "
                        "pool = n/pool_div lanes, each running "
                        "pool_div*spp work items")
    p.add_argument("--engine", type=str, default="auto",
                   choices=["auto", "persistent", "hybrid"],
                   help="auto: hybrid for legacy mesh scenes, persistent "
                        "for sphere scenes")
    p.add_argument("--cap", type=int, default=0,
                   help="hybrid survivor batch width (0 = auto: slab/8)")
    p.add_argument("--pool-w", type=int, default=0,
                   help="hybrid secondary pool width (0 = auto: sized for "
                        "all primary survivors, see integrator/hybrid.py)")
    p.add_argument("--drain-ratio", type=int, default=2,
                   help="hybrid end-of-render cascade narrowing ratio")
    p.add_argument("--chunk-spp", type=int, default=0,
                   help="hybrid primary slab spp (0 = auto)")
    p.add_argument("--scene", type=str, default="10_final",
                   choices=["10_final", "yoimiya"],
                   help="10_final: sphere cover scene (headline); "
                        "yoimiya: 23k-tri mesh BVH workload")
    p.add_argument("--time1024", action="store_true",
                   help="report wall seconds to render 1024spp at 1080p "
                        "(time-to-quality)")
    p.add_argument("--sweep-res", action="store_true",
                   help="resolution-scaling guard: print one JSON line per "
                        "resolution (720p/1080p/1440p/4K at --spp)")
    p.add_argument("--flagship", action="store_true",
                   help="the reference's flagship mesh workload: Yoimiya at "
                        "3000x2000, 32 spp, depth 32 "
                        "(legacy/PT_in_one_weekend/15_module.py:36-44); "
                        "reports wall seconds for the full frame")
    args = p.parse_args()
    if args.time1024 and args.flagship:
        p.error("--time1024 and --flagship are mutually exclusive")
    if args.time1024:
        args.width, args.height, args.spp = 1920, 1080, 1024
    if args.flagship:
        args.scene = "yoimiya"
        args.width, args.height, args.spp = 3000, 2000, 32

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from learn_path_tracing_tpu.integrator.persistent import render_persistent
    from learn_path_tracing_tpu.utils.runtime import (device_record,
                                                      enable_compile_cache,
                                                      route)

    enable_compile_cache()
    # a measurement needs the GPU; the CPU only when asked for by name
    if route() != "gpu" and args.platform != "cpu":
        print(f"bench.py: JAX found no GPU ({jax.devices()[0].platform}); "
              f"pass --platform cpu for a rehearsal", file=sys.stderr)
        return 1
    device = device_record()

    res = (args.width, args.height)
    if args.scene == "10_final":
        from learn_path_tracing_tpu.models import random_scene, stage10_camera

        wd = random_scene(seed=20230328).device()

        def make_cam(r):
            return stage10_camera(r).params()

        scene_kind, bsdf = "spheres", "modern"
        metric = "mrays_per_sec_10final"
    else:
        import warnings

        from learn_path_tracing_tpu.camera import LegacyCamera
        from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld
        from learn_path_tracing_tpu.stages.legacy_common import make_asset_path_map

        world = LegacyWorld()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            wd = world.load("/root/reference/legacy/Yoimiya.world.npy",
                            path_map=make_asset_path_map())

        def make_cam(r):
            cam = LegacyCamera(r)
            cam.set_fov(30)
            cam.set_position((0, 8, -30))
            cam.look_at((0, 8, 0))
            return cam.params()

        scene_kind, bsdf = "legacy", "legacy"
        metric = "bvh_mrays_per_sec_yoimiya"

    # The legacy camera has no lens (aperture=0, focal=1): use the 'jitter'
    # model, bit-identical to degenerate thinlens (tests/test_camera.py) but
    # skips the disk sample + second RNG hash on every regen pass.
    cam_model = "jitter" if scene_kind == "legacy" else "thinlens"
    engine = args.engine
    if engine == "auto":
        engine = "hybrid" if scene_kind == "legacy" else "persistent"

    if engine == "hybrid":
        from learn_path_tracing_tpu.integrator.hybrid import render_hybrid

        def run(seed, res=res, cp=None):
            return render_hybrid(wd, cp or make_cam(res), res, spp=args.spp,
                                 limit=args.limit, seed=seed, bsdf=bsdf,
                                 camera_model=cam_model, scene=scene_kind,
                                 hit_backend=args.hit_backend,
                                 chunk_spp=args.chunk_spp, cap=args.cap,
                                 pool_w=args.pool_w,
                                 drain_ratio=args.drain_ratio)
    else:
        def run(seed, res=res, cp=None):
            return render_persistent(wd, cp or make_cam(res), res,
                                     spp=args.spp, limit=args.limit,
                                     seed=seed, bsdf=bsdf,
                                     camera_model=cam_model,
                                     scene=scene_kind,
                                     hit_backend=args.hit_backend,
                                     pool_mult=args.pool_mult,
                                     pool_div=args.pool_div)

    def emit(name, value, unit, **extra):
        print(json.dumps({"metric": name, "value": value, "unit": unit,
                          **extra, "hit_backend": args.hit_backend,
                          "engine": engine, "device": device}), flush=True)

    def timed(r, iters):
        """(seconds per render, segments per render) after a warm-up."""
        cp = make_cam(r)
        jax.block_until_ready(run(-1, res=r, cp=cp))   # compile + warm-up
        t0 = time.perf_counter()
        segs = []
        for i in range(iters):
            _, s = run(i, res=r, cp=cp)
            segs.append(s)
        segs = [float(s) for s in jax.block_until_ready(segs)]
        return (time.perf_counter() - t0) / iters, sum(segs) / iters

    if args.time1024:
        dt, segs = timed(res, 1)
        emit(f"seconds_to_1024spp_1080p_{args.scene}", dt, "s",
             mrays_per_sec=segs / dt / 1e6)
    elif args.flagship:
        dt, segs = timed(res, 1)
        emit("seconds_flagship_3000x2000_spp32_yoimiya", dt, "s",
             mrays_per_sec=segs / dt / 1e6)
    elif args.sweep_res:
        for r in ((1280, 720), (1920, 1080), (2560, 1440), (3840, 2160)):
            dt, segs = timed(r, args.iters)
            emit(f"{metric}_{r[0]}x{r[1]}_spp{args.spp}", segs / dt / 1e6,
                 "Mrays/s", seconds=dt)
    else:
        dt, segs = timed(res, args.iters)
        emit(metric, segs / dt / 1e6, "Mrays/s", seconds=dt, segments=segs)
    if args.trace:
        cp = make_cam(res)
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(run(args.iters, cp=cp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
