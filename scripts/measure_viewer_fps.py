"""Interactive frame rates of the progressive viewer on the device.

Times ProgressiveRenderer.render() — the exact per-frame call the HTTP
viewer makes — on the Yoimiya mesh world and the 10_final sphere scene at
the reference's interactive config (640x360, 12_free_view.py:26-30), for
both moving (accumulator restart / motion preview) and still (accumulate)
frames.

Usage: python scripts/measure_viewer_fps.py [--frames 5]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _force(frame):
    import jax

    return jax.block_until_ready(frame)


def time_frames(pr, moved, frames):
    _force(pr.render(moved=moved))   # compile
    best = 1e9
    for _ in range(frames):
        t0 = time.perf_counter()
        _force(pr.render(moved=moved))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=5)
    args = p.parse_args()

    from learn_path_tracing_tpu.camera import LegacyCamera
    from learn_path_tracing_tpu.viewer.progressive import ProgressiveRenderer
    from worldcache import load_world

    res = (640, 360)

    configs = []
    wd = load_world()

    def mk_cam():
        cam = LegacyCamera(res)
        cam.set_fov(30)
        cam.set_position((0, 8, -30))
        cam.look_at((0, 8, 0))
        return cam

    for spp in (4, 8, 16):
        configs.append(("yoimiya", wd, spp, 10, 0))
    # preview mode: spp 4, limit 2 while moving
    configs.append(("yoimiya+preview", wd, 16, 10, 4))

    for name, world, spp, limit, pspp in configs:
        pr = ProgressiveRenderer(world, mk_cam(), res, spp_per_frame=spp,
                                 limit=limit, bsdf="legacy", scene="legacy",
                                 preview_spp=pspp, preview_limit=2)
        dt_m = time_frames(pr, True, args.frames)
        dt_s = time_frames(pr, False, args.frames)
        print(f"{name:16s} spp={spp:3d} limit={limit}  "
              f"moving {dt_m*1e3:7.1f} ms ({1/dt_m:5.2f} fps)  "
              f"still {dt_s*1e3:7.1f} ms ({1/dt_s:5.2f} fps)", flush=True)


if __name__ == "__main__":
    main()
