"""Hybrid integrator vs reference-mode render: identical RNG counters per
(pixel, sample, bounce), so per-sample radiance matches bitwise and only
the per-pixel f32 summation order differs (~1 ulp); traced-segment counts
match exactly (every path is traced exactly once in either integrator)."""

import numpy as np
import pytest

from learn_path_tracing_tpu.camera import Camera
from learn_path_tracing_tpu.integrator.hybrid import render_hybrid
from learn_path_tracing_tpu.integrator.wavefront import render


def _mini_legacy_world():
    # (moved from the retired test_cohort.py: the cohort integrator was
    # deleted after the hybrid superseded it)
    import warnings

    from learn_path_tracing_tpu.io.obj import MeshData
    from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld

    world = LegacyWorld()
    world.add_mesh(MeshData(
        positions=np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]],
                           np.float32),
        normals=np.array([[0, 1, 0]], np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        face_p=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_n=np.zeros((2, 3), np.int32),
        face_t=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_tex=np.zeros(2, np.int32),
    ))
    world.add_sphere((0, 1, 0), 0.8, transparency=0, texture_id=0)
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return world.build()


RES = (28, 20)


def _cam():
    cam = Camera(RES)
    cam.set_position((0, 2, 6))
    cam.look_at((0, 0.5, 0))
    return cam


@pytest.mark.slow  # compiles two full legacy integrator graphs (~80 s/core)
def test_hybrid_equals_wavefront_legacy():
    wd = _mini_legacy_world()
    cam = _cam()
    a_img, a_seg = render(wd, cam.params(), RES, spp=3, limit=6, seed=7,
                          bsdf="legacy", scene="legacy")
    b_img, b_seg = render_hybrid(wd, cam.params(), RES, spp=3, limit=6,
                                 seed=7, bsdf="legacy", scene="legacy",
                                 camera_model="thinlens", chunk_spp=1)
    assert np.allclose(np.asarray(a_img), np.asarray(b_img),
                       rtol=0, atol=5e-7)
    assert float(a_seg) == float(b_seg)


def test_hybrid_pool_geometry_invariant():
    """chunk_spp / cap / pool width are implementation details: any choice
    yields the same image (same RNG counters) and segment count — including
    a cap SMALLER than the survivor count (multi-round spill) and a pool
    that must repeatedly make room."""
    wd = _mini_legacy_world()
    cam = _cam()
    base_img = base_seg = None
    for kwargs in (
        dict(chunk_spp=1),
        dict(chunk_spp=2),
        dict(chunk_spp=1, cap=256, pool_w=256),
        dict(chunk_spp=4, cap=256, pool_w=512),
    ):
        img, seg = render_hybrid(wd, cam.params(), RES, spp=4, limit=8,
                                 seed=3, bsdf="legacy", scene="legacy",
                                 camera_model="thinlens", **kwargs)
        if base_img is None:
            base_img, base_seg = np.asarray(img), float(seg)
        else:
            assert float(seg) == base_seg, kwargs
            assert np.allclose(base_img, np.asarray(img), rtol=0,
                               atol=5e-7), kwargs


def test_hybrid_matches_persistent_segments_and_image():
    from learn_path_tracing_tpu.integrator.persistent import render_persistent

    wd = _mini_legacy_world()
    cam = _cam()
    a_img, a_seg = render_persistent(wd, cam.params(), RES, spp=4, limit=8,
                                     seed=3, bsdf="legacy", scene="legacy",
                                     camera_model="thinlens")
    b_img, b_seg = render_hybrid(wd, cam.params(), RES, spp=4, limit=8,
                                 seed=3, bsdf="legacy", scene="legacy",
                                 camera_model="thinlens")
    assert float(a_seg) == float(b_seg)
    assert np.allclose(np.asarray(a_img), np.asarray(b_img), rtol=0,
                       atol=5e-7)


def test_hybrid_limit_one_is_primary_only():
    """limit=1 renders escape radiance of camera rays only (the reference's
    propagate budget semantics, 15_module.py:1031) — the pool phase is
    statically skipped and segment count is exactly n*spp."""
    wd = _mini_legacy_world()
    cam = _cam()
    a_img, a_seg = render(wd, cam.params(), RES, spp=2, limit=1, seed=1,
                          bsdf="legacy", scene="legacy")
    b_img, b_seg = render_hybrid(wd, cam.params(), RES, spp=2, limit=1,
                                 seed=1, bsdf="legacy", scene="legacy",
                                 camera_model="thinlens")
    assert float(a_seg) == float(b_seg) == RES[0] * RES[1] * 2
    assert np.allclose(np.asarray(a_img), np.asarray(b_img), rtol=0,
                       atol=5e-7)


def test_hybrid_sample_base_accumulates_exactly():
    """Two sample_base-offset calls of spp/2 average to the one-shot spp
    render (identical RNG counters per absolute sample; the viewer's
    progressive accumulation contract)."""
    import jax.numpy as jnp

    wd = _mini_legacy_world()
    cam = _cam()
    full, full_seg = render_hybrid(wd, cam.params(), RES, spp=4, limit=6,
                                   seed=9, bsdf="legacy", scene="legacy",
                                   camera_model="thinlens")
    a, sa = render_hybrid(wd, cam.params(), RES, spp=2, limit=6, seed=9,
                          bsdf="legacy", scene="legacy",
                          camera_model="thinlens",
                          sample_base=jnp.uint32(0))
    b, sb = render_hybrid(wd, cam.params(), RES, spp=2, limit=6, seed=9,
                          bsdf="legacy", scene="legacy",
                          camera_model="thinlens",
                          sample_base=jnp.uint32(2))
    assert float(sa) + float(sb) == float(full_seg)
    merged = (np.asarray(a) + np.asarray(b)) / 2.0
    assert np.allclose(merged, np.asarray(full), rtol=0, atol=5e-7)


def test_hybrid_rejects_non_legacy_scene():
    with pytest.raises(ValueError):
        render_hybrid(None, None, RES, spp=2, scene="spheres")
