"""Legacy stage 12: free-fly camera with progressive accumulation
(/root/reference/legacy/PT_in_one_weekend/12_free_view.py:553-579).

There is no window on a headless GPU host; this stage runs a scripted WASD-style
flythrough: each "keyframe" applies camera moves (the same move_front/
move_right/move_up/rotate controls as the reference) and renders a
progressively-accumulated frame, resetting accumulation on movement —
exactly the reference's ``render(moved)`` behavior. Use --script to supply
a comma-separated move list (e.g. "w,w,a,r+10-5,.,.") where '.' holds still
(accumulates) and 'r+Y-P' rotates.
"""

import jax

from ..camera import LegacyCamera
from ..viewer.progressive import ProgressiveRenderer
from .common import parse_args
from ..utils.config import STAGE_CONFIGS
from .l11_bvh import legacy_random_scene
from .legacy_common import save_frame

VELOCITY = 1.0


def apply_move(cam: LegacyCamera, token: str) -> bool:
    """Apply one move token; returns True if the camera moved."""
    if token == ".":
        return False
    if token == "w":
        cam.move_front(VELOCITY)
    elif token == "s":
        cam.move_front(-VELOCITY)
    elif token == "a":
        cam.move_right(-VELOCITY)
    elif token == "d":
        cam.move_right(VELOCITY)
    elif token == "space":
        cam.move_up(VELOCITY)
    elif token == "shift":
        cam.move_up(-VELOCITY)
    elif token.startswith("r"):
        import re

        m = re.match(r"r([+-]\d+)([+-]\d+)", token)
        if not m:
            raise ValueError(f"bad rotate token {token!r}")
        cam.rotate(float(m.group(1)), float(m.group(2)))
    else:
        raise ValueError(f"unknown move token {token!r}")
    return True


def main():
    import argparse
    import sys

    argv = sys.argv[1:]
    script = "w,w,.,.,d,r+15+0,.,."
    if "--script" in argv:
        i = argv.index("--script")
        script = argv[i + 1]
        del argv[i:i + 2]
    sys.argv[1:] = argv

    args = parse_args(STAGE_CONFIGS["l12"], description=__doc__)
    res = (args.width, args.height)
    world = legacy_random_scene()
    wd = world.device(use_bvh=True)

    cam = LegacyCamera(res)
    cam.set_fov(20)
    cam.set_position((13, 2, 3))
    cam.look_at((0, 0, 0))

    pr = ProgressiveRenderer(wd, cam, res, spp_per_frame=args.spp,
                             limit=min(args.limit, 10), bsdf="legacy",
                             scene="spheres", hit_backend="bvh")
    for i, token in enumerate(script.split(",")):
        moved = apply_move(cam, token)
        frame = pr.render(moved=moved)
        save_frame(jax.block_until_ready(frame),
                   args.out or f"outputs/l12_free_view_{i:03d}.png")
        print(f"frame {i}: token={token!r} moved={moved} spp={pr.spp}")
        if args.out:
            break


if __name__ == "__main__":
    main()
