"""Legacy line: OBJ loading, texture atlas, serialization, mesh-world render."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from learn_path_tracing_tpu.bsdf.bsdf import scatter_legacy
from learn_path_tracing_tpu.camera import Camera
from learn_path_tracing_tpu.core import rng
from learn_path_tracing_tpu.core.types import Rays
from learn_path_tracing_tpu.integrator.wavefront import render
from learn_path_tracing_tpu.io.obj import MeshData, load_obj
from learn_path_tracing_tpu.io.texture import (
    TextureManager,
    sample_bilinear,
)
from learn_path_tracing_tpu.scene.legacy_world import (
    LegacyWorld,
    environment_color,
    hit_legacy,
)
from learn_path_tracing_tpu.scene.serialize import load_world_npy

REF_LEGACY = "/root/reference/legacy"
needs_ref = pytest.mark.skipif(
    not os.path.isdir(REF_LEGACY), reason="reference worlds unavailable")


# ------------------------------------------------------------------- OBJ --

def test_load_obj(tmp_path):
    mtl = tmp_path / "m.mtl"
    mtl.write_text("newmtl red\nmap_Kd red.png\nnewmtl blue\nmap_Kd blue.png\n")
    obj = tmp_path / "t.obj"
    obj.write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "vn 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 0 1\n"
        "usemtl red\n"
        "f 1/1/1 2/2/1 3/3/1\n"
        "usemtl blue\n"
        "f 2/1/1 4/2/1 3/3/1\n")
    mesh = load_obj(str(obj), texture_start_id=5)
    assert mesh.n_faces == 2
    assert mesh.positions.shape == (4, 3)
    assert mesh.face_p.tolist() == [[0, 1, 2], [1, 3, 2]]
    assert mesh.face_tex.tolist() == [5, 6]
    assert [t["id"] for t in mesh.textures] == [5, 6]


def test_load_obj_flip_and_transform(tmp_path):
    obj = tmp_path / "t.obj"
    obj.write_text("v 1 2 3\nvn 0 0 1\nvt 0.25 0.75\n")
    mesh = load_obj(str(obj), flip_z=True, flip_textcoord=True)
    assert mesh.positions.tolist() == [[1.0, 2.0, -3.0]]
    assert mesh.normals.tolist() == [[0.0, 0.0, -1.0]]
    assert np.allclose(mesh.uvs, [[0.25, 0.25]])

    rot = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], float)  # yaw 90
    mesh2 = load_obj(str(obj), transform=rot)
    assert np.allclose(mesh2.positions, [[3.0, 2.0, -1.0]])


@needs_ref
def test_load_reference_obj():
    path = "/root/reference/assets/models/Yoimiya/Yoimiya_ShapeChange.obj"
    mesh = load_obj(path, texture_start_id=1, flip_z=True, flip_textcoord=True)
    assert mesh.n_faces == 23425
    assert set(np.unique(mesh.face_tex)) <= {1, 2, 3, 4}
    assert len(mesh.textures) == 4


# --------------------------------------------------------------- packing --

def test_texture_manager_packing():
    tm = TextureManager((64, 64))
    tm.add("a", 0, size=(32, 32))
    tm.add("b", 1, size=(32, 32))
    tm.add("c", 2, size=(64, 16))
    tm.build()
    rects = []
    for cfg in tm.configs:
        low, high = cfg["area"]["low"], cfg["area"]["high"]
        assert 0 <= low[0] < high[0] <= 64
        assert 0 <= low[1] < high[1] <= 64
        assert (high[0] - low[0], high[1] - low[1]) == cfg["size"]
        rects.append((low, high))
    # no overlaps
    for i in range(len(rects)):
        for j in range(i + 1, len(rects)):
            (l1, h1), (l2, h2) = rects[i], rects[j]
            sep = (h1[0] <= l2[0] or h2[0] <= l1[0]
                   or h1[1] <= l2[1] or h2[1] <= l1[1])
            assert sep, (rects[i], rects[j])


def test_texture_manager_overflow():
    tm = TextureManager((32, 32))
    tm.add("a", 0, size=(32, 32))
    tm.add("b", 1, size=(2, 2))
    with pytest.raises(MemoryError):
        tm.build()


def test_texture_manager_dump_load_roundtrip():
    tm = TextureManager((64, 64))
    tm.add("x", 3, size=(16, 8))
    tm.build()
    d = tm.dump()
    tm2 = TextureManager((1, 1))
    tm2.load(d)
    assert tm2.size == (64, 64)
    assert tm2.configs[0]["area"]["low"] == (0, 0)
    assert tm2.configs[0]["id"] == 3


# --------------------------------------------------------------- sampler --

def test_bilinear_constant_and_gradient():
    img = np.zeros((8, 4, 2), np.float32)
    img[..., 0] = 7.0                      # constant channel
    img[..., 1] = np.arange(8)[:, None]    # u-gradient channel
    info_low = jnp.array([[0, 0]], jnp.int32)
    info_high = jnp.array([[8, 4]], jnp.int32)
    tex = jnp.zeros((5,), jnp.int32)
    u = jnp.array([0.1, 0.3, 0.5, 0.7, 0.9])
    v = jnp.full((5,), 0.5)
    out = np.asarray(sample_bilinear(jnp.asarray(img), info_low, info_high,
                                     tex, u, v))
    assert np.allclose(out[:, 0], 7.0, atol=1e-5)
    # gradient channel increases with u
    assert (np.diff(out[:, 1]) > 0).all()


def test_bilinear_wraps_inside_rect():
    # two rects side by side; sampling rect 0 at u slightly over 1 must wrap
    # into rect 0, never leak into rect 1
    img = np.zeros((8, 4, 1), np.float32)
    img[0:4] = 1.0   # rect 0 all ones
    img[4:8] = 100.0  # rect 1 poison
    info_low = jnp.array([[0, 0], [4, 0]], jnp.int32)
    info_high = jnp.array([[4, 4], [8, 4]], jnp.int32)
    u = jnp.array([0.999, 1.2, -0.1])
    v = jnp.array([0.5, 0.5, 0.5])
    out = np.asarray(sample_bilinear(jnp.asarray(img), info_low, info_high,
                                     jnp.zeros(3, jnp.int32), u, v))
    assert np.allclose(out, 1.0, atol=1e-5)


def test_strip_sampler_matches_classic():
    # strip packing must reproduce the classic 4-gather bilinear exactly
    # (same texels, same weights) including u/v wrap-around, multi-rect
    # atlases, and sub-stride rect widths
    from learn_path_tracing_tpu.io.texture import (
        pack_strips, sample_bilinear_strips)

    rng = np.random.default_rng(11)
    img = rng.uniform(0.0, 2.0, (40, 16, 8)).astype(np.float32)
    info_low = jnp.array([[0, 0], [19, 0], [24, 3]], jnp.int32)
    info_high = jnp.array([[19, 16], [24, 5], [40, 11]], jnp.int32)
    strips = pack_strips(img, info_low, info_high, texels=16)
    n = 257
    tex = jnp.asarray(rng.integers(0, 3, n), jnp.int32)
    u = jnp.asarray(rng.uniform(-0.4, 1.7, n), jnp.float32)
    v = jnp.asarray(rng.uniform(-0.4, 1.7, n), jnp.float32)
    classic = np.asarray(sample_bilinear(jnp.asarray(img), info_low,
                                         info_high, tex, u, v))
    fast = np.asarray(sample_bilinear_strips(strips, tex, u, v, channels=8))
    np.testing.assert_allclose(fast, classic, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- serialize --

def _quad_mesh(tex_id=0):
    return MeshData(
        positions=np.array([[0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0]], np.float32),
        normals=np.array([[0, 0, 1]], np.float32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        face_p=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_n=np.array([[0, 0, 0], [0, 0, 0]], np.int32),
        face_t=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        face_tex=np.array([tex_id, tex_id], np.int32),
        textures=[],
    )


def test_world_npy_roundtrip(tmp_path):
    world = LegacyWorld()
    world.add_mesh(_quad_mesh())
    world.add_sphere((0, 1, 2), 0.5, transparency=1, texture_id=0)
    world.textures.add("missing_texture", 0, size=(8, 8))
    world.set_environment(0)
    with pytest.warns(UserWarning):
        world.build()
    path = str(tmp_path / "x.world.npy")
    world.save(path)

    data = load_world_npy(path)
    assert data["environment"] == 0
    assert len(data["meshes_bvhs"]) == 1
    assert data["spheres_bvh"] is not None
    m = data["meshes_bvhs"][0]
    assert m["faces"]["p"].shape == (2, 3)
    assert np.allclose(m["positions"],
                       [[0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0]])
    s = data["spheres_bvh"]["spheres"]
    assert np.allclose(s["center"], [[0, 1, 2]])
    assert s["transparency"][0] == 1


@pytest.mark.slow  # compiles hit_legacy twice (~40 s/core)
def test_world_npy_roundtrip_renders_identically(tmp_path):
    world = LegacyWorld()
    world.add_mesh(_quad_mesh())
    world.add_sphere((0, 1, 2), 0.5, transparency=1, texture_id=0)
    world.textures.add("missing_texture", 0, size=(8, 8))
    world.set_environment(0)
    with pytest.warns(UserWarning):
        world.build()
    path = str(tmp_path / "x.world.npy")
    world.save(path)
    world2 = LegacyWorld()
    with pytest.warns(UserWarning):
        wd2 = world2.load(path)
    wd1 = world.device()
    r = _rays([[0.5, 1.0, 5]], [[0, 0, -1]])
    h1 = hit_legacy(wd1, r)
    h2 = hit_legacy(wd2, r)
    assert np.allclose(float(h1.t[0]), float(h2.t[0]), atol=1e-6)
    assert np.allclose(np.asarray(h1.normal), np.asarray(h2.normal), atol=1e-6)


@needs_ref
def test_reference_worlds_load():
    for name, tris in [("demo", [2]), ("Zhongli", [16884])]:
        data = load_world_npy(f"{REF_LEGACY}/{name}.world.npy")
        assert [m["faces"]["p"].shape[0] for m in data["meshes_bvhs"]] == tris
        for m in data["meshes_bvhs"]:
            nodes = m["nodes"]
            inner = nodes["data"] < 0
            assert (nodes["left"][inner] >= 0).all()
            assert int(m["cut"][-1]) == m["faces"]["p"].shape[0]


@pytest.mark.slow
def test_14era_world_textures_from_companion_obj():
    # 14-era files carry no texture configs; the reference loads them from
    # the companion OBJ's materials into fixed 2048-wide slots
    # (14_mesh.py:994-999). Without this, Zhongli renders as a black
    # silhouette (zero albedo).
    from learn_path_tracing_tpu.stages.legacy_common import (
        companion_obj_for, make_asset_path_map)

    path = f"{REF_LEGACY}/Zhongli.world.npy"
    world = LegacyWorld()
    import warnings as _w

    with _w.catch_warnings():
        _w.simplefilter("ignore")
        wd = world.load(path, path_map=make_asset_path_map(),
                        textures_from_obj=companion_obj_for(path))
    assert len(world.textures.configs) >= 4
    # atlas must contain real texture data (nonzero albedo somewhere)
    a = np.asarray(wd.atlas.table, np.float32)
    assert float(np.abs(a).max()) > 0.01


def test_malicious_pickle_rejected(tmp_path):
    import pickle

    path = tmp_path / "evil.world.npy"
    np.save(str(path), np.array(None))  # placeholder to get header right
    # hand-craft: npy header + pickle of os.system reference
    import numpy.lib.format as fmt
    import io as _io

    buf = _io.BytesIO()
    fmt.write_array_header_2_0(
        buf, {"descr": "|O", "fortran_order": False, "shape": ()})
    evil = pickle.dumps(os.system)
    with open(path, "wb") as f:
        f.write(b"\x93NUMPY\x02\x00")
        f.write(buf.getvalue()[8:] if buf.getvalue()[:6] == b"\x93NUMPY"
                else buf.getvalue())
        f.write(evil)
    with pytest.raises(Exception):
        load_world_npy(str(path))


# ------------------------------------------------------------ mesh world --

def _rays(ro, rd):
    ro = jnp.asarray(ro, jnp.float32).reshape(-1, 3)
    rd = jnp.asarray(rd, jnp.float32).reshape(-1, 3)
    n = ro.shape[0]
    return Rays(ro=ro, rd=rd, throughput=jnp.ones((n, 3), jnp.float32),
                alive=jnp.ones((n,), bool))


def _built_world():
    world = LegacyWorld()
    world.add_mesh(_quad_mesh())
    world.add_sphere((5, 0, 0), 1.0, transparency=0, texture_id=0)
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        world.build()
    return world


def test_hit_legacy_mesh_and_sphere():
    world = _built_world()
    wd = world.device()
    r = _rays([[0.5, 1.0, 5], [5, 0, 5], [10, 10, 5]],
              [[0, 0, -1], [0, 0, -1], [0, 0, -1]])
    h = hit_legacy(wd, r)
    assert bool(h.hit[0]) and bool(h.hit[1]) and not bool(h.hit[2])
    assert np.isclose(float(h.t[0]), 5.0, atol=1e-4)      # quad at z=0
    assert np.isclose(float(h.t[1]), 4.0, atol=1e-4)      # sphere front
    assert np.allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-5)
    # legacy constants
    assert np.isclose(float(h.material.ior[0]), 1.5)
    assert np.isclose(float(h.material.absorptivity[0]), 0.25)
    # neutral missing-texture fill: albedo 0.5**2.2
    assert np.allclose(np.asarray(h.material.albedo[0]), 0.5 ** 2.2, atol=1e-3)


def test_hit_legacy_multi_mesh():
    # Two meshes composed in one world (the reference builds one BVH per
    # mesh and min-reduces across them, 15_module.py:807-810): nearest mesh
    # must win per ray, attributes must come from the right mesh, and the
    # global prim offsets of the shared tri_attr table must resolve.
    world = LegacyWorld()
    near = _quad_mesh()
    world.add_mesh(near)                       # quad at z=0
    far = _quad_mesh()
    far.positions = far.positions + np.array([0, 0, -3], np.float32)
    world.add_mesh(far)                        # identical quad at z=-3
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        world.build(merge_meshes=False)   # per-mesh composition under test;
        # the merged-BVH default is covered by tests/test_multimesh.py
    wd = world.device()
    assert len(wd.meshes) == 2
    # from the front: near quad wins; from behind: far quad wins
    h = hit_legacy(wd, _rays([[0.5, 1.0, 5], [0.5, 1.0, -8]],
                             [[0, 0, -1], [0, 0, 1]]))
    assert bool(h.hit[0]) and bool(h.hit[1])
    assert np.isclose(float(h.t[0]), 5.0, atol=1e-4)
    assert np.isclose(float(h.t[1]), 5.0, atol=1e-4)
    assert np.allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-5)
    # backface of the far quad (its geometric normal faces +z)
    assert np.allclose(np.asarray(h.normal[1]), [0, 0, -1], atol=1e-5)


def test_hit_legacy_backface():
    world = _built_world()
    wd = world.device()
    r = _rays([[0.5, 1.0, -5]], [[0, 0, 1]])  # hits quad from behind
    h = hit_legacy(wd, r)
    assert bool(h.hit[0])
    assert np.allclose(np.asarray(h.normal[0]), [0, 0, -1], atol=1e-5)
    assert np.isclose(float(h.material.ior[0]), 1 / 1.5, atol=1e-6)
    assert float(h.material.absorptivity[0]) == 0.0


def test_environment_color_mapping():
    world = _built_world()
    wd = world.device()
    rd = jnp.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    col = np.asarray(environment_color(wd.envs, wd.env_id, rd))
    assert col.shape == (2, 3)
    assert np.isfinite(col).all()


def test_gradient_env_analytic_matches_tap():
    """A world whose environment file is missing bakes the sky gradient;
    the analytic fast path (env_gradient_h) must reproduce the atlas tap."""
    world = _built_world()
    wd = world.device()
    assert wd.env_gradient_h is not None  # _built_world has no real env
    rs = np.random.RandomState(7)
    rd = rs.normal(size=(4096, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    rd = jnp.asarray(rd)
    tapped = np.asarray(environment_color(wd.envs, wd.env_id, rd))
    analytic = np.asarray(environment_color(
        wd.envs, wd.env_id, rd, gradient_h=wd.env_gradient_h))
    np.testing.assert_allclose(analytic, tapped, atol=2e-6)


def test_scatter_legacy_properties():
    world = _built_world()
    wd = world.device()
    n = 4096
    r = _rays(np.tile([0.5, 1.0, 5], (n, 1)), np.tile([0, 0, -1], (n, 1)))
    h = hit_legacy(wd, r)
    base = rng.base(rng.stream(0, 0, 0), jnp.arange(n, dtype=jnp.uint32))
    out = scatter_legacy(r, h, base)
    d = np.asarray(out.rd)
    assert np.allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-4)
    # origin offset 2 epsilon along normal
    assert np.allclose(np.asarray(out.ro)[:, 2], 2e-4, atol=1e-6)
    # metallic=0 here: split between diffuse (attenuated) and fresnel reflect
    tp = np.asarray(out.throughput)
    attenuated = tp[:, 0] < 0.9
    # attenuation = albedo * (1 - absorptivity) = 0.5^2.2 * 0.75
    expect = 0.5 ** 2.2 * 0.75
    assert np.allclose(tp[attenuated, 0], expect, atol=1e-3)
    frac_specular = 1.0 - attenuated.mean()
    assert abs(frac_specular - 0.04) < 0.02  # F0(ior 1.5) = 0.04


def test_render_legacy_end_to_end():
    world = _built_world()
    wd = world.device()
    cam = Camera((32, 24), fov=50)
    cam.set_position((1.0, 1.0, 6.0))
    cam.look_at((1.0, 1.0, 0.0))
    img, segs = render(wd, cam.params(), (32, 24), spp=2, limit=4, seed=1,
                       bsdf="legacy", scene="legacy")
    img = np.asarray(img)
    assert img.shape == (32, 24, 3)
    assert np.isfinite(img).all()
    assert float(segs) > 32 * 24 * 2  # secondary bounces happened


@needs_ref
@pytest.mark.slow  # full legacy render graph compile (~20 s/core)
def test_demo_world_renders():
    world = LegacyWorld()
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = world.load(f"{REF_LEGACY}/demo.world.npy")
    cam = Camera((24, 16))
    cam.set_position((0.0, 2.0, 8.0))
    cam.look_at((0.0, 0.0, 0.0))
    img, _ = render(wd, cam.params(), (24, 16), spp=1, limit=3, seed=0,
                    bsdf="legacy", scene="legacy")
    assert np.isfinite(np.asarray(img)).all()


def test_sphere_scan_matches_lockstep_legacy_semantics(np_rng):
    """The brute-force sphere scan (geometry/sphere.py) and the lockstep
    sphere-BVH walk hit_legacy runs must agree on the legacy sphere rules
    (t_min epsilon + transparent far-root, 11_bvh.py:424-431)."""
    from learn_path_tracing_tpu.accel.bvh import build_bvh
    from learn_path_tracing_tpu.accel.traverse import (
        make_sphere_leaf_test,
        traverse,
    )
    from learn_path_tracing_tpu.geometry.sphere import intersect_spheres

    ns, nr = 97, 256
    centers = (np_rng.random((ns, 3)).astype(np.float32) - 0.5) * 20
    radii = (np_rng.random(ns).astype(np.float32) * 0.8 + 0.2)
    transparency = (np_rng.random(ns) < 0.3).astype(np.float32)
    ro = (np_rng.random((nr, 3)).astype(np.float32) - 0.5) * 24
    rd = np_rng.normal(size=(nr, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    bvh = build_bvh(centers - radii[:, None], centers + radii[:, None],
                    centroid=centers, max_depth=10, max_leaf=4)
    lt = make_sphere_leaf_test(jnp.asarray(centers), jnp.asarray(radii),
                               jnp.asarray(transparency))
    t0, p0 = traverse(bvh, jnp.asarray(ro), jnp.asarray(rd), lt)
    t1, p1 = intersect_spheres(
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(centers),
        jnp.asarray(radii), jnp.asarray(transparency))
    t1 = jnp.where(jnp.isfinite(t1), t1, jnp.inf)

    t0, t1 = np.asarray(t0), np.asarray(t1)
    hit0 = np.isfinite(t0)
    assert np.array_equal(hit0, np.isfinite(t1))
    np.testing.assert_allclose(t0[hit0], t1[hit0], rtol=1e-5, atol=1e-5)
    assert np.array_equal(np.asarray(p0)[hit0], np.asarray(p1)[hit0])


def test_shade_attrs_compaction_matches_direct():
    """The hit-lane compaction in _shade_attrs (sort -> prefix block ->
    unsort) must be value-identical to running _attrs_block full-width, for
    every prefix branch AND the full fallback."""
    from learn_path_tracing_tpu.scene.legacy_world import (
        _attrs_block, _shade_attrs)

    import jax

    world = _built_world()
    wd = world.device()
    n = 8192   # >= the 4096 compaction threshold; prefixes = {512, 2048}
    rng_ = np.random.default_rng(7)

    def check(hit_frac):
        hit = jnp.asarray(rng_.random(n) < hit_frac)
        point = jnp.asarray(rng_.normal(size=(n, 3)).astype(np.float32))
        tcount = int(wd.tri_attr.shape[0])
        pidx = jnp.asarray(rng_.integers(0, tcount, n).astype(np.int32))
        # src: 0 = sphere, 1 = mesh for hit lanes; -1 for misses
        src = jnp.asarray(rng_.integers(0, 2, n).astype(np.int32))
        src = jnp.where(hit, src, -1)
        pidx = jnp.where(hit, pidx, 0)
        # sphere lanes must index real spheres
        scount = int(wd.spheres.center.shape[0])
        pidx = jnp.where((src == 0) & hit, pidx % scount, pidx)
        direct = jax.jit(_attrs_block)(wd, point, pidx, src, hit)
        compact = jax.jit(_shade_attrs)(wd, point, pidx, src, hit)
        for d, c in zip(direct, compact):
            # jit fusion differences allow ~1 ulp; values must otherwise match
            np.testing.assert_allclose(np.asarray(d), np.asarray(c),
                                       rtol=3e-7, atol=3e-7)

    check(0.02)    # first prefix (n/16)
    check(0.15)    # second prefix (n/4)
    check(0.80)    # full fallback


@pytest.mark.slow
def test_trace_shade_compact_matches_hit_legacy():
    """trace_shade_compact (payload through the hit-compaction sort, no
    restoring sort) must agree with hit_legacy per work item: same hit set,
    same t/attrs for each carried tag, hits exactly in the prefix
    [0, nhits)."""
    from learn_path_tracing_tpu.scene.legacy_world import trace_shade_compact

    world = LegacyWorld()
    world.add_mesh(_quad_mesh())
    world.textures.add("missing", 0, size=(8, 8))
    world.set_environment(0)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        world.build()
    wd = world.device()

    n = 2048
    rs = np.random.RandomState(13)
    target = np.concatenate(
        [rs.uniform(0.05, 1.95, (n, 2)), np.zeros((n, 1))], axis=1)
    ro = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    ro[:, 2] = np.where(rs.rand(n) < 0.5, rs.uniform(2, 6, n),
                        rs.uniform(-6, -2, n)).astype(np.float32)
    rd = (target - ro).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    alive = rs.rand(n) > 0.15
    rays = Rays(ro=jnp.asarray(ro), rd=jnp.asarray(rd),
                throughput=jnp.ones((n, 3), jnp.float32),
                alive=jnp.asarray(alive))

    ref = hit_legacy(wd, rays)  # composed path, lane order
    tag = jnp.arange(n, dtype=jnp.uint32)
    hits, rd_c, (tag_c,), nhits = trace_shade_compact(
        wd, rays.ro, rays.rd, rays.alive, (tag,))

    tag_c = np.asarray(tag_c)
    nhits = int(nhits)
    hit_ref = np.asarray(ref.hit)
    # prefix rows are exactly the reference's hit lanes (as a set)
    assert nhits == hit_ref.sum()
    assert np.array_equal(np.sort(tag_c[:nhits]),
                          np.flatnonzero(hit_ref).astype(np.uint32))
    assert np.asarray(hits.hit)[:nhits].all()
    assert not np.asarray(hits.hit)[nhits:].any()
    # per work item: t and geometry bitwise, taps within fusion 1-ulp
    inv = tag_c[:nhits]
    np.testing.assert_array_equal(np.asarray(hits.t)[:nhits],
                                  np.asarray(ref.t)[inv])
    np.testing.assert_array_equal(np.asarray(hits.obj)[:nhits],
                                  np.asarray(ref.obj)[inv])
    for name in ("normal", "uv", "point"):
        np.testing.assert_array_equal(np.asarray(getattr(hits, name))[:nhits],
                                      np.asarray(getattr(ref, name))[inv])
    np.testing.assert_array_equal(np.asarray(rd_c)[:nhits],
                                  np.asarray(rays.rd)[inv])
    for name in ("albedo", "roughness", "metallic", "ior", "absorptivity",
                 "transparency"):
        np.testing.assert_allclose(
            np.asarray(getattr(hits.material, name))[:nhits],
            np.asarray(getattr(ref.material, name))[inv],
            rtol=3e-7, atol=1e-7)
