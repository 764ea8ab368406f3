"""CPU self-goldens for the legacy pipeline.

The reference validates its legacy renders visually at full resolution on
GPU; CI needs something that runs on one CPU core. These tests re-render
two tiny fixed-seed scenes and pixel-compare against PNGs committed by
scripts/make_self_goldens.py — any semantic drift in hit_legacy,
scatter_legacy, .world.npy loading, the texture/environment atlases, or
the EXR codec moves these pixels. The GPU runs the same XLA traversal
path; chip_smoke.py compares it with the same golden on the card.

Tolerance: the renders are deterministic for a fixed seed; the tolerance
only absorbs uint8 quantization plus cross-version XLA FMA/fusion changes
(~1 ulp in f32 radiance, well under 1/255 after gamma).
"""

import os
import warnings

import numpy as np
import pytest

from learn_path_tracing_tpu.camera import Camera
from learn_path_tracing_tpu.core import image as image_io
from learn_path_tracing_tpu.integrator.wavefront import render

GOLD = os.path.join(os.path.dirname(__file__), "goldens_self")
REF_LEGACY = "/root/reference/legacy"

needs_ref = pytest.mark.skipif(
    not os.path.isdir(REF_LEGACY), reason="reference assets not available")


def _compare(img, name, mean_tol=0.5 / 255, max_tol=2.0 / 255):
    golden = image_io.read_png(os.path.join(GOLD, name))
    ours = image_io.from_raster(image_io.to_raster(np.asarray(img)))
    assert ours.shape == golden.shape, (ours.shape, golden.shape)
    diff = np.abs(ours - golden)
    assert diff.mean() <= mean_tol, (diff.mean(), diff.max())
    assert diff.max() <= max_tol, (diff.mean(), diff.max())


@needs_ref
def test_demo_world_golden():
    from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld

    world = LegacyWorld()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = world.load(f"{REF_LEGACY}/demo.world.npy")
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
    img, _ = render(wd, cam.params(), res, spp=4, limit=1, seed=0,
                    bsdf="legacy", scene="legacy")
    _compare(np.asarray(img) ** (1 / 2.2), "demo_96x54_spp4l1_seed0.png")


def test_ibl_mesh_golden(tmp_path):
    from learn_path_tracing_tpu.models import ibl_mesh_scene

    res = (64, 36)
    wd, cam = ibl_mesh_scene(str(tmp_path / "env.exr"), res)
    img, _ = render(wd, cam.params(), res, spp=4, limit=6, seed=3,
                    bsdf="legacy", scene="legacy")
    _compare(np.asarray(img) ** (1 / 2.2), "ibl_mesh_64x36_spp4_seed3.png")
