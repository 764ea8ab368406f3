"""Generate the committed CPU self-goldens for the legacy pipeline.

The reference ships no small-scene legacy goldens (its character renders
are full-res PNGs validated visually), so CI pins the legacy render
semantics with tiny SELF-rendered images instead: fixed seed, CPU backend,
committed under tests/goldens_self/. Any semantic drift in
hit_legacy / scatter_legacy / serialization / atlas sampling changes these
pixels and fails the fast tier without needing a GPU.

Run from the repo root after an INTENTIONAL semantic change:
    python scripts/make_self_goldens.py
and commit the regenerated PNGs together with the change that justified
them.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

GOLD = os.path.join(os.path.dirname(__file__), "..", "tests", "goldens_self")


def demo_world_golden():
    from learn_path_tracing_tpu.camera import Camera
    from learn_path_tracing_tpu.core import image as image_io
    from learn_path_tracing_tpu.integrator.wavefront import render
    from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld

    import warnings

    world = LegacyWorld()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = world.load("/root/reference/legacy/demo.world.npy")
    res = (96, 54)
    # demo.world.npy ships no texture configs, so its atlas region is
    # all-zeros — black albedo AND a zero normal map (the reference taps
    # the same uninitialized fields and normalizes a zero vector,
    # 15_module.py:888-890). limit=1 keeps the render meaningful: the
    # sphere pins serialization + sphere hit + camera as a silhouette
    # against the analytic gradient environment.
    cam = Camera(res, fov=40)
    cam.set_position((0.0, 0.6, 3.2))
    cam.look_at((0.0, 0.0, 0.0))
    img, segs = render(wd, cam.params(), res, spp=4, limit=1, seed=0,
                       bsdf="legacy", scene="legacy")
    img = np.asarray(img) ** (1 / 2.2)   # legacy display gamma
    path = os.path.join(GOLD, "demo_96x54_spp4l1_seed0.png")
    image_io.write_png(img, path)
    print(f"wrote {path}  segments={float(segs):.0f} "
          f"mean={img.mean():.4f}")


def ibl_mesh_golden():
    """Textured mini-mesh under a synthetic HDR EXR environment: pins the
    full legacy chain (EXR decode -> env atlas -> strip tap -> mesh hit ->
    texture atlas -> scatter_legacy) in one image."""
    import tempfile
    import warnings

    from learn_path_tracing_tpu.camera import Camera
    from learn_path_tracing_tpu.core import image as image_io
    from learn_path_tracing_tpu.integrator.wavefront import render
    from learn_path_tracing_tpu.io.exr import write_exr
    from learn_path_tracing_tpu.io.obj import MeshData
    from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld

    h, w = 32, 64
    env = np.zeros((h, w, 3), np.float32)
    ys = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    env[:] = (1 - ys) * np.array([4.0, 2.0, 0.5]) + ys * np.array(
        [0.2, 0.4, 1.5])

    quad = MeshData(
        positions=np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                           np.float32) * 2.0,
        normals=np.array([[0, 1, 0]], np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        face_p=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_n=np.array([[0, 0, 0], [0, 0, 0]], np.int32),
        face_t=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_tex=np.array([0, 0], np.int32),
        textures=[],
    )

    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "env.exr")
        write_exr(p, env, half=False, compression="zip")
        world = LegacyWorld(environment_size=(128, 64))
        world.add_mesh(quad)
        world.add_sphere((0.0, 1.0, 0.0), 0.8, transparency=0, texture_id=0)
        world.textures.add("missing_texture", 0, size=(8, 8))
        world.environments.add(p, 0)
        world.set_environment(0)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            world.build()
        wd = world.device()

    res = (64, 36)
    cam = Camera(res, fov=50)
    cam.set_position((0.0, 2.0, 5.0))
    cam.look_at((0.0, 0.8, 0.0))
    img, segs = render(wd, cam.params(), res, spp=4, limit=6, seed=3,
                       bsdf="legacy", scene="legacy")
    img = np.asarray(img) ** (1 / 2.2)
    path = os.path.join(GOLD, "ibl_mesh_64x36_spp4_seed3.png")
    image_io.write_png(img, path)
    print(f"wrote {path}  segments={float(segs):.0f} "
          f"mean={img.mean():.4f}")


if __name__ == "__main__":
    os.makedirs(GOLD, exist_ok=True)
    demo_world_golden()
    ibl_mesh_golden()
