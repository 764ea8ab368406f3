"""Four-character showcase: compose all 4 shipped OBJs in ONE world.

The reference's World API composes N meshes + spheres in one scene
(/root/reference/legacy/PT_in_one_weekend/15_module.py:782-848) but every
shipped demo is single-mesh. This renders Yoimiya + Zhongli + Ganyu +
Barbara side by side (~90k triangles total) — the multi-mesh path the
merged global BVH exists for: one traversal per wavefront
regardless of mesh count (scene/legacy_world._merge_mesh_geometry).

Usage: python scripts/render_four_characters.py [--spp 128] [--res 960x540]
       [--merge 1] [--out outputs/validate/four_characters.png]
"""

import argparse
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import worldcache  # noqa: F401  (persistent XLA compile cache config)

ASSETS = "/root/reference/assets"
CHARACTERS = [  # (obj relpath, x offset)
    ("models/Zhongli/Zhongli.obj", -13.5),
    ("models/Yoimiya/Yoimiya_ShapeChange.obj", -4.5),
    ("models/Barbara/Barbara.obj", 4.5),
    ("models/Ganyu/Ganyu.obj", 13.5),
]


def build_four_world(merge=True):
    import numpy as np

    from learn_path_tracing_tpu.io.obj import load_obj
    from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld
    from learn_path_tracing_tpu.stages.legacy_common import make_asset_path_map

    world = LegacyWorld()
    world.environments.add("./textures/cayley_interior_2k.exr", 0,
                           size=(2048, 1024))
    world.set_environment(0)
    rot = np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float64)
    tex_id = 1
    for rel, dx in CHARACTERS:
        mesh = load_obj(os.path.join(ASSETS, rel), texture_start_id=tex_id,
                        flip_z=True, flip_textcoord=True, transform=rot)
        mesh.positions = mesh.positions + np.array([dx, 0, 0], np.float32)
        for tex in mesh.textures:
            world.textures.add(tex["file_path"], tex["id"])
        tex_id += len(mesh.textures)
        world.add_mesh(mesh)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = world.build(path_map=make_asset_path_map(),
                         merge_meshes=merge)
    return wd


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--spp", type=int, default=128)
    p.add_argument("--limit", type=int, default=32)
    p.add_argument("--res", type=str, default="960x540")
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--merge", type=int, default=1)
    p.add_argument("--engine", type=str, default="persistent",
                   choices=["persistent", "hybrid"])
    p.add_argument("--out", type=str,
                   default="outputs/validate/four_characters.png")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from learn_path_tracing_tpu.camera import LegacyCamera
    from learn_path_tracing_tpu.core import image as image_io

    w, h = (int(v) for v in args.res.split("x"))
    res = (w, h)
    t0 = time.time()
    wd = build_four_world(merge=bool(args.merge))
    print(f"world build: {time.time()-t0:.1f}s "
          f"({len(wd.meshes)} device mesh structure(s))", flush=True)

    cam = LegacyCamera(res)
    cam.set_fov(40)
    cam.set_position((0, 8, -34))
    cam.look_at((0, 8, 0))
    cp = cam.params()

    if args.engine == "hybrid":
        from learn_path_tracing_tpu.integrator.hybrid import render_hybrid as R
    else:
        from learn_path_tracing_tpu.integrator.persistent import (
            render_persistent as R)

    add = jax.jit(lambda a, b, w, s, t: (a + b * w, s + t))
    acc = segs = None
    t0 = time.time()
    for s0 in range(0, args.spp, args.chunk):
        n_s = min(args.chunk, args.spp - s0)
        img, sg = R(wd, cp, res, spp=n_s,
                    limit=args.limit, seed=s0, bsdf="legacy",
                    camera_model="jitter", scene="legacy")
        acc, segs = ((img * float(n_s), sg) if acc is None
                     else add(acc, img, float(n_s), segs, sg))
    segs_f = float(segs) + float(jnp.sum(acc)) * 0.0
    dt = time.time() - t0
    frame = acc / args.spp
    print(f"render: {dt:.1f}s, {segs_f/1e6:.1f} Msegs = "
          f"{segs_f/dt/1e6:.2f} Mrays/s (incl. compile)", flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    image_io.write_png(jnp.clip(frame, 0.0, 1.0) ** (1 / 2.2), args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
