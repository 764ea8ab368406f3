"""Golden-image regression against the reference's rendered outputs.

Stages 2-4 are deterministic (no RNG anywhere in their pipelines), so our
renders must match /root/reference/outputs/*.png almost pixel-exactly —
differences come only from f32 math ordering and PNG quantization.

MC stages (5-10) are compared statistically elsewhere (chip_smoke.py);
doing 8192-spp renders on the test CPU is not practical.
"""

import os

import numpy as np
import pytest

from learn_path_tracing_tpu.camera import Camera
from learn_path_tracing_tpu.core import image
from learn_path_tracing_tpu.integrator.wavefront import sky_background
from learn_path_tracing_tpu.models import stage3_scene, stage4_scene
from learn_path_tracing_tpu.stages.common import render_normal_shaded

GOLDEN_DIR = "/root/reference/outputs"

needs_goldens = pytest.mark.skipif(
    not os.path.isdir(GOLDEN_DIR), reason="reference goldens not available"
)


def golden_res(golden_name):
    g = image.read_png(os.path.join(GOLDEN_DIR, golden_name))
    return (g.shape[0], g.shape[1])


def compare(img, golden_name, mean_tol=1.5 / 255, p99_tol=4.0 / 255):
    golden = image.read_png(os.path.join(GOLDEN_DIR, golden_name))
    ours = np.asarray(img, dtype=np.float32)
    assert ours.shape == golden.shape, (ours.shape, golden.shape)
    # quantize ours the same way the PNG writer does
    ours_q = image.from_raster(image.to_raster(ours))
    diff = np.abs(ours_q - golden)
    assert diff.mean() < mean_tol, f"mean diff {diff.mean()*255:.2f}/255"
    assert np.quantile(diff, 0.99) < p99_tol, (
        f"p99 diff {np.quantile(diff, 0.99)*255:.2f}/255"
    )


@needs_goldens
def test_stage1_gradient():
    import jax.numpy as jnp

    w = h = 256
    i = jnp.arange(w, dtype=jnp.float32)[:, None]
    j = jnp.arange(h, dtype=jnp.float32)[None, :]
    img = jnp.stack([
        jnp.broadcast_to(i / w, (w, h)),
        jnp.broadcast_to(j / h, (w, h)),
        jnp.zeros((w, h)),
    ], axis=-1)
    compare(img, "1_save_img.png")


@needs_goldens
def test_stage2_sky():
    from learn_path_tracing_tpu.camera.camera import generate_rays

    res = (1280, 720)
    cam = Camera(res)
    cam.set_direction(0, 30, 0)
    rays = generate_rays(cam.params(), res, 0, 0, model="center")
    img = np.asarray(sky_background(rays.rd)).reshape(res[0], res[1], 3)
    compare(img, "2_camera_and_ray.png")


@needs_goldens
def test_stage3_sphere_normals():
    res = (1280, 720)
    cam = Camera(res)
    cam.set_direction(0, 0)
    img = render_normal_shaded(stage3_scene().device(), cam.params(), res)
    compare(img, "3_adding_a_sphere.png")


@needs_goldens
def test_stage4_world_normals():
    res = golden_res("4_objects.png")
    cam = Camera(res)
    cam.set_direction(0, 0)
    cam.set_position((0.0, 0.0, 3.0))
    img = render_normal_shaded(stage4_scene().device(), cam.params(), res)
    compare(img, "4_objects.png")
