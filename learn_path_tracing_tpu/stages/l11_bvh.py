"""Legacy stage 11: sphere BVH + orbiting camera
(/root/reference/legacy/PT_in_one_weekend/11_bvh.py:487-535): the cover
scene with legacy materials (absorptivity, continuous roughness), SAH
sphere BVH, fov 20, thin lens (10, 0.1), camera orbiting at radius 15.
Frames are written as PNGs (the ti.GUI window has no analog on a headless host).
"""

import math
import random as _random

import jax

from ..camera import LegacyCamera
from ..core.types import Material
from ..integrator.wavefront import render
from ..scene.world import Sphere, World
from .common import parse_args
from ..utils.config import STAGE_CONFIGS
from .legacy_common import save_frame


def legacy_random_scene(size=11, seed=1234) -> World:
    rng = _random.Random(seed)
    world = World()
    world.add(Sphere((0, -10000, 0), 10000, Material(
        albedo=(1, 1, 1), roughness=1, metallic=0, ior=1.5, absorptivity=0.5)))
    for a in range(-size, size):
        for b in range(-size, size):
            choose = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if ((center[0] - 4) ** 2 + center[2] ** 2) ** 0.5 > 0.9:
                albedo = (rng.random(), rng.random(), rng.random())
                if choose < 0.8:
                    world.add(Sphere(center, 0.2, Material(
                        albedo=albedo, roughness=1, metallic=0, ior=1.5)))
                elif choose < 0.95:
                    world.add(Sphere(center, 0.2, Material(
                        albedo=tuple(0.5 + 0.5 * c for c in albedo),
                        roughness=0.5 * rng.random(), metallic=1, ior=0)))
                else:
                    world.add(Sphere(center, 0.2, Material(
                        albedo=tuple(0.75 + 0.25 * c for c in albedo),
                        roughness=0.2 * rng.random(), metallic=0, ior=1.5,
                        transparency=1)))
    world.add(Sphere((0, 1, 0), 1.0, Material(albedo=(1, 1, 1), roughness=0,
                                              metallic=0, ior=1.5, transparency=1)))
    world.add(Sphere((-4, 1, 0), 1.0, Material(albedo=(0.4, 0.2, 0.1),
                                               roughness=1, metallic=0, ior=1.5)))
    world.add(Sphere((4, 1, 0), 1.0, Material(albedo=(0.7, 0.6, 0.5),
                                              roughness=0, metallic=1, ior=0)))
    return world


def main():
    args = parse_args(STAGE_CONFIGS["l11"], description=__doc__)
    res = (args.width, args.height)
    world = legacy_random_scene()
    wd = world.device(use_bvh=True)

    cam = LegacyCamera(res)
    cam.set_fov(20)
    cam.set_len(10, 0.1)

    frames = 8
    for i in range(frames):
        cam.set_position((15 * math.cos(0.1 * i + 1e-4), 2,
                          15 * math.sin(0.1 * i + 1e-4)))
        cam.look_at((0, 0, 0))
        # hit_backend from config (default 'auto' = the sphere scan);
        # pass --hit-backend bvh for the reference-structure lockstep
        # BVH walk
        img, _ = render(wd, cam.params(), res, spp=args.spp,
                        limit=min(args.limit, 10), seed=i, bsdf="legacy",
                        hit_backend=args.hit_backend)
        img = jax.jit(lambda x: x ** (1 / 2.2))(img)
        save_frame(img, args.out or f"outputs/l11_bvh_{i:03d}.png")
        if args.out:
            break


if __name__ == "__main__":
    main()
