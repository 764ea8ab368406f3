"""Pass-count + segment telemetry for the hybrid integrator on the bench
config. Prints the stats dict (chunking, pool widths, total pool passes)
and the segment totals, so knob sweeps can be reasoned about without
guessing occupancy.

Usage: python scripts/hybrid_stats.py [--chunk 0] [--cap 0] [--poolw 0]
       [--spp 64]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--chunk", type=int, default=0)
    p.add_argument("--cap", type=int, default=0)
    p.add_argument("--poolw", type=int, default=0)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--limit", type=int, default=32)
    p.add_argument("--res", type=str, default="640x360",
                   help="WxH (the bench config is 1280x720)")
    args = p.parse_args()

    from learn_path_tracing_tpu.camera import LegacyCamera
    from learn_path_tracing_tpu.integrator.hybrid import render_hybrid
    from worldcache import load_world

    res = tuple(int(v) for v in args.res.split("x"))
    n = res[0] * res[1]
    wd = load_world()
    cam = LegacyCamera(res)
    cam.set_fov(30)
    cam.set_position((0, 8, -30))
    cam.look_at((0, 8, 0))
    cp = cam.params()

    img, segs, st = render_hybrid(
        wd, cp, res, spp=args.spp, limit=args.limit, seed=0, bsdf="legacy",
        camera_model="jitter", scene="legacy", chunk_spp=args.chunk,
        cap=args.cap, pool_w=args.poolw, stats=True)
    segs = float(segs)
    passes = float(st["passes"])
    primary = n * args.spp
    print(f"stats: {st}")
    print(f"segments total:    {segs/1e6:.2f} M")
    print(f"primary segments:  {primary/1e6:.2f} M "
          f"({100.0*primary/segs:.1f}%)")
    print(f"secondary segs:    {(segs-primary)/1e6:.2f} M")
    slots = 0.0
    for w_, p_ in st["passes_by_width"]:
        p_ = float(p_)
        slots += float(w_) * p_
        if p_:
            print(f"  width {int(w_):>8}: {p_:5.0f} passes")
    print(f"pool passes:       {passes:.0f}, {slots/1e6:.2f} M lane-slots "
          f"-> occupancy {(segs-primary)/max(slots,1)*100:.1f}%")
    print(f"mean path length:  {segs/primary:.3f}")


if __name__ == "__main__":
    main()
