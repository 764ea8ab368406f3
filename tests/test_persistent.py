"""Path-regeneration integrator vs reference-mode render: identical RNG
counters and per-pixel accumulation order, so results agree to 1 ulp (XLA
may contract FMAs differently between the two programs) and segment counts
match exactly."""

import numpy as np

from learn_path_tracing_tpu.camera import Camera
from learn_path_tracing_tpu.integrator.persistent import render_persistent
from learn_path_tracing_tpu.integrator.wavefront import render
from learn_path_tracing_tpu.models import stage6_scene, stage8_scene

RES = (28, 20)


def test_bitwise_equal_modern():
    world = stage8_scene()
    cam = Camera(RES)
    cam.set_position((0, 0.4, 4))
    wd = world.device()
    a_img, a_seg = render(wd, cam.params(), RES, spp=6, limit=8, seed=11)
    b_img, b_seg = render_persistent(wd, cam.params(), RES, spp=6, limit=8,
                                     seed=11)
    assert np.allclose(np.asarray(a_img), np.asarray(b_img),
                       rtol=0, atol=5e-7)
    assert float(a_seg) == float(b_seg)


def test_bitwise_equal_diffuse():
    world = stage6_scene()
    cam = Camera(RES)
    cam.set_position((0, 0, 4))
    wd = world.device()
    a_img, a_seg = render(wd, cam.params(), RES, spp=4, limit=16, seed=3,
                          bsdf="diffuse")
    b_img, b_seg = render_persistent(wd, cam.params(), RES, spp=4, limit=16,
                                     seed=3, bsdf="diffuse")
    assert np.allclose(np.asarray(a_img), np.asarray(b_img),
                       rtol=0, atol=5e-7)
    assert float(a_seg) == float(b_seg)


import pytest


@pytest.mark.slow  # compiles two full legacy integrator graphs (~80 s/core)
def test_bitwise_equal_legacy_scene():
    import warnings

    from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld
    from learn_path_tracing_tpu.io.obj import MeshData
    import numpy as _np

    world = LegacyWorld()
    world.add_mesh(MeshData(
        positions=_np.array([[-3, 0, -3], [3, 0, -3], [3, 0, 3], [-3, 0, 3]],
                            _np.float32),
        normals=_np.array([[0, 1, 0]], _np.float32),
        uvs=_np.array([[0, 0], [1, 0], [1, 1], [0, 1]], _np.float32),
        face_p=_np.array([[0, 1, 2], [0, 2, 3]], _np.int32),
        face_n=_np.zeros((2, 3), _np.int32),
        face_t=_np.array([[0, 1, 2], [0, 2, 3]], _np.int32),
        face_tex=_np.zeros(2, _np.int32),
    ))
    world.add_sphere((0, 1, 0), 0.8, transparency=0, texture_id=0)
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = world.build()

    cam = Camera(RES)
    cam.set_position((0, 2, 6))
    cam.look_at((0, 0.5, 0))
    a_img, a_seg = render(wd, cam.params(), RES, spp=3, limit=6, seed=7,
                          bsdf="legacy", scene="legacy")
    b_img, b_seg = render_persistent(wd, cam.params(), RES, spp=3, limit=6,
                                     seed=7, bsdf="legacy", scene="legacy")
    assert np.allclose(np.asarray(a_img), np.asarray(b_img),
                       rtol=0, atol=5e-7)
    assert float(a_seg) == float(b_seg)


def test_nondivisor_pool_matches_default():
    """pool need not divide n*spp: items_per is a ceiling and overshoot
    item slots are masked invalid. A pool_div that leaves a ragged
    schedule must produce the same image and segment count (flagship
    3000x2000-style configs have no power-of-2-friendly divisors)."""
    world = stage8_scene()
    cam = Camera(RES)
    cam.set_position((0, 0.4, 4))
    wd = world.device()
    # RES 28x20 -> n=560, spp=4: pool_div=3 -> pool=ceil(186/4)*4=188,
    # items_per=ceil(2240/188)=12, groups 47 * 12 = 564 > 560 -> 4 masked
    a_img, a_seg = render_persistent(wd, cam.params(), RES, spp=4, limit=8,
                                     seed=11)
    b_img, b_seg = render_persistent(wd, cam.params(), RES, spp=4, limit=8,
                                     seed=11, pool_div=3)
    assert np.allclose(np.asarray(a_img), np.asarray(b_img),
                       rtol=0, atol=5e-7)
    assert float(a_seg) == float(b_seg)


def test_factorized_accumulate_matches_flat():
    """acc_split=P switches the accumulator to the factorized two-one-hot
    routing (k = q*P + p) — kept as an ablation knob.
    Same term set per (group, item) cell, so only f32 add order within a
    cell may differ (~1 ulp) from the flat path — and both must match the
    reference-mode wavefront image with exact segment counts."""
    res = (32, 32)
    world = stage8_scene()
    cam = Camera(res)
    cam.set_position((0, 0.4, 4))
    wd = world.device()
    # n=1024, spp=16, pool_div=16 -> pool=64, items_per=256 (factorized);
    # pool_div=2 -> pool=512, items_per=32 (flat path)
    a_img, a_seg = render_persistent(wd, cam.params(), res, spp=16, limit=6,
                                     seed=7, pool_div=16, acc_split=16)
    b_img, b_seg = render_persistent(wd, cam.params(), res, spp=16, limit=6,
                                     seed=7, pool_div=2)
    c_img, c_seg = render(wd, cam.params(), res, spp=16, limit=6, seed=7)
    assert np.allclose(np.asarray(a_img), np.asarray(b_img),
                       rtol=0, atol=5e-7)
    assert np.allclose(np.asarray(a_img), np.asarray(c_img),
                       rtol=0, atol=5e-7)
    assert float(a_seg) == float(b_seg) == float(c_seg)


def test_windowed_accumulate_matches_flat():
    """acc_split=-2 forces the sliding-window accumulator (the default past
    _ACC_SPLIT_MIN_ITEMS work items — the round-5 fix for the 1080p 2x
    resolution-scaling loss and the time1024 spp-512 worker crash). The
    window deposits the same per-(group, item) term set as the flat
    one-hot, so images must match to f32 add-order (~1 ulp) and segment
    counts exactly; pool_div=16 gives items_per >> ACC_WINDOW/2 so the
    half-window flush path runs, and a tiny window would park lanes —
    covered by the schedule invariant (parked lanes trace nothing, so
    segments stay exact)."""
    res = (36, 32)
    world = stage8_scene()
    cam = Camera(res)
    cam.set_position((0, 0.4, 4))
    wd = world.device()
    a_img, a_seg = render_persistent(wd, cam.params(), res, spp=16, limit=6,
                                     seed=7, pool_div=16, acc_split=-2)
    b_img, b_seg = render_persistent(wd, cam.params(), res, spp=16, limit=6,
                                     seed=7, pool_div=16, acc_split=1)
    c_img, c_seg = render(wd, cam.params(), res, spp=16, limit=6, seed=7)
    assert np.allclose(np.asarray(a_img), np.asarray(b_img),
                       rtol=0, atol=5e-7)
    assert np.allclose(np.asarray(a_img), np.asarray(c_img),
                       rtol=0, atol=5e-7)
    assert float(a_seg) == float(b_seg) == float(c_seg)


def test_windowed_accumulate_parking():
    """Drive the window so small that lanes park: shrink ACC_WINDOW to the
    minimum slide granularity and use long item lists. Parking must only
    reschedule work (identical radiance and exact segment counts), never
    drop deposits."""
    import learn_path_tracing_tpu.integrator.persistent as P

    res = (40, 32)   # distinct shape -> no jit-cache collision with the
    world = stage8_scene()   # default-window traces
    cam = Camera(res)
    cam.set_position((0, 0.4, 4))
    wd = world.device()
    old = P.ACC_WINDOW
    P.ACC_WINDOW = 8
    try:
        a_img, a_seg = render_persistent(wd, cam.params(), res, spp=16,
                                         limit=6, seed=7, pool_div=16,
                                         acc_split=-2)
    finally:
        P.ACC_WINDOW = old
    b_img, b_seg = render_persistent(wd, cam.params(), res, spp=16, limit=6,
                                     seed=7, pool_div=16, acc_split=1)
    assert np.allclose(np.asarray(a_img), np.asarray(b_img),
                       rtol=0, atol=5e-7)
    assert float(a_seg) == float(b_seg)
