"""The platform switch, the compile cache, the sphere hit query against the
f64 intersection oracle, the XLA BVH traversal the GPU runs for mesh and
sphere-BVH worlds, the PNG codec, and chip_smoke.py's refusal to run
without a GPU. Tests marked ``gpu`` need the card and skip
here (see the ``gpu`` fixture in conftest.py)."""

import os
import struct
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from learn_path_tracing_tpu.core.image import decode_png, encode_png
from learn_path_tracing_tpu.geometry.sphere import intersect_spheres
from learn_path_tracing_tpu.geometry.sphere_f64 import (compare_hits,
                                                        nearest_hit,
                                                        secondary_rays)
from learn_path_tracing_tpu.utils import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- route --

@pytest.mark.parametrize("platform,expected", [
    ("gpu", "gpu"), ("cuda", "gpu"), ("cpu", "cpu")])
def test_route(platform, expected):
    assert runtime.route(platform) == expected


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron"])
def test_route_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        runtime.route(platform)


def test_route_default_is_this_process_backend():
    assert runtime.route() == "cpu"   # the tests run on the CPU


# -------------------------------------------------------- compile cache --

@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = runtime.compile_cache_dir()
        # a fixed directory inside the checkout, listed in .gitignore
        assert path == os.path.join(ROOT, ".jax_cache")
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / env))
        assert runtime.compile_cache_dir() == str(tmp_path / env)


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert runtime.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old[1])


# ------------------------------------------- f64 oracle, 10_final table --

def _final_world():
    from learn_path_tracing_tpu.models import random_scene

    return random_scene(seed=20230328).device(use_bvh=True)


def _table(wd):
    return wd.centers, wd.radii, wd.materials.transparency


def _rays(kind, table, n=384, seed=0):
    """Ray sets that stress the quadratic differently: camera rays, rays
    leaving hit points (self-hit cancellation), and shallow rays onto the
    10,000-radius ground sphere."""
    from learn_path_tracing_tpu.camera.camera import generate_rays
    from learn_path_tracing_tpu.models import stage10_camera

    rng = np.random.default_rng(seed)
    res = (24, 16)
    prim = generate_rays(stage10_camera(res).params(), res, 0, 0,
                         model="thinlens")
    ro, rd = np.asarray(prim.ro), np.asarray(prim.rd)
    if kind == "primary":
        return ro, rd
    if kind == "secondary":
        t, idx = map(np.asarray, intersect_spheres(prim.ro, prim.rd, *table))
        return secondary_rays(ro, rd, t, idx, *map(np.asarray, table[:2]),
                              n, rng)
    # ground: shallow downward rays from just above it
    ro2 = np.stack([rng.uniform(-12, 12, n), rng.uniform(0.1, 3, n),
                    rng.uniform(-12, 12, n)], -1).astype(np.float32)
    rd2 = rng.normal(size=(n, 3)).astype(np.float32)
    rd2[:, 1] = -np.abs(rd2[:, 1]) * 0.2
    rd2 /= np.linalg.norm(rd2, axis=-1, keepdims=True)
    return ro2, rd2


@pytest.mark.parametrize("backend", ["xla", "bvh"])
@pytest.mark.parametrize("kind", ["primary", "secondary", "ground"])
def test_hit_matches_f64_oracle(kind, backend):
    """``scene.world.hit`` by the brute-force scan and by the sphere BVH on
    the 10_final table (padded to 512), ground sphere included."""
    from learn_path_tracing_tpu.core.types import Rays
    from learn_path_tracing_tpu.scene.world import hit

    wd = _final_world()
    table = _table(wd)
    ro, rd = _rays(kind, table)
    rays = Rays(ro=jnp.asarray(ro), rd=jnp.asarray(rd),
                throughput=jnp.ones_like(jnp.asarray(ro)),
                alive=jnp.ones((len(ro),), bool))
    h = hit(wd, rays, backend=backend)
    t = np.where(np.asarray(h.hit), np.asarray(h.t), np.inf)
    t64, i64 = nearest_hit(ro, rd, *map(np.asarray, table))
    c = compare_hits(ro, rd, *table, t, np.asarray(h.obj), t64, i64,
                     round_oc=True)
    assert c["unexplained"] == 0, c
    assert c["hits"] > len(ro) // 4, c   # the set really hits the scene
    # rounding decides only tangent rays, ties and a few surface re-hits
    assert c["explained_by_rounding"] <= 0.01 * len(ro), c


@pytest.mark.parametrize("backend", ["pallas", "mxu"])
def test_hit_refuses_unknown_backend(backend):
    from learn_path_tracing_tpu.core.types import Rays
    from learn_path_tracing_tpu.models import stage3_scene
    from learn_path_tracing_tpu.scene.world import hit

    rays = Rays(ro=jnp.zeros((1, 3)), rd=jnp.array([[0.0, 0.0, -1.0]]),
                throughput=jnp.ones((1, 3)), alive=jnp.ones((1,), bool))
    with pytest.raises(ValueError, match="unknown hit backend"):
        hit(stage3_scene().device(), rays, backend=backend)


@pytest.mark.parametrize("n", [1, 127, 128, 129])
def test_padded_sphere_table_never_hits_padding(n):
    """World.device() pads the table to a multiple of 128 with radius-0
    spheres at the origin; rays through the origin must never report one."""
    from learn_path_tracing_tpu.core.types import Rays
    from learn_path_tracing_tpu.scene.world import Sphere, World, hit

    rng = np.random.default_rng(n)
    world = World([Sphere(tuple(rng.uniform(-20, 20, 3)), 0.5)
                   for _ in range(n)])
    wd = world.device()
    assert wd.radii.shape[0] % 128 == 0 and wd.radii.shape[0] >= n
    ro = rng.normal(size=(64, 3)).astype(np.float32) * 10
    rd = -ro / np.linalg.norm(ro, axis=-1, keepdims=True)   # via the origin
    rays = Rays(ro=jnp.asarray(ro), rd=jnp.asarray(rd),
                throughput=jnp.ones((64, 3)), alive=jnp.ones((64,), bool))
    h = hit(wd, rays)
    obj = np.asarray(h.obj)
    assert np.all(obj < n)
    assert np.all(obj[np.asarray(h.hit)] >= 0)


# ------------------------------- XLA BVH traversal vs brute force -------

def _brute_force(leaf_test, n_prim, ro, rd):
    """Every primitive's leaf test for every ray; first index wins ties."""
    n = ro.shape[0]
    ts = jnp.stack([leaf_test(jnp.full((n,), p, jnp.int32),
                              jnp.ones((n,), bool), ro, rd)
                    for p in range(n_prim)], axis=1)
    return np.asarray(jnp.min(ts, axis=1)), np.asarray(jnp.argmin(ts, axis=1))


@pytest.mark.parametrize("leaf", ["triangle", "sphere"])
def test_traverse_wide_matches_brute_force(np_rng, leaf):
    from learn_path_tracing_tpu.accel.bvh import build_bvh
    from learn_path_tracing_tpu.accel.traverse import (
        make_sphere_leaf_test, make_triangle_leaf_test)
    from learn_path_tracing_tpu.accel.wide import collapse, traverse_wide

    n_p, n_r = 60, 128
    if leaf == "triangle":
        v0 = np_rng.normal(size=(n_p, 3)).astype(np.float32) * 3
        v1 = v0 + np_rng.normal(size=(n_p, 3)).astype(np.float32)
        v2 = v0 + np_rng.normal(size=(n_p, 3)).astype(np.float32)
        lo = np.minimum(np.minimum(v0, v1), v2)
        hi = np.maximum(np.maximum(v0, v1), v2)
        cen = (v0 + v1 + v2) / 3
        lt = make_triangle_leaf_test(*map(jnp.asarray, (v0, v1, v2)))
    else:
        cen = np_rng.normal(size=(n_p, 3)).astype(np.float32) * 4
        r = np_rng.uniform(0.2, 1.0, size=n_p).astype(np.float32)
        tr = (np_rng.uniform(size=n_p) < 0.3).astype(np.float32)
        lo, hi = cen - r[:, None], cen + r[:, None]
        lt = make_sphere_leaf_test(*map(jnp.asarray, (cen, r, tr)))
    wide = collapse(build_bvh(lo, hi, centroid=cen, max_depth=12,
                              max_leaf=4))
    # rays from outside aimed near random primitives, so most of them hit
    ro = np_rng.normal(size=(n_r, 3)).astype(np.float32) * 8
    rd = (cen[np_rng.integers(0, n_p, n_r)] - ro
          + np_rng.normal(size=(n_r, 3)).astype(np.float32) * 0.3)
    ro = jnp.asarray(ro)
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=-1, keepdims=True))

    t_w, p_w = map(np.asarray, traverse_wide(wide, ro, rd, lt))
    t_b, p_b = _brute_force(lt, n_p, ro, rd)
    hit = np.isfinite(t_b)
    assert hit.sum() > n_r // 2
    assert np.array_equal(np.isfinite(t_w), hit)
    # the same leaf math in another fusion (FMA contraction differs), so t
    # agrees to f32 roundoff and another primitive wins only at a tie
    if leaf == "sphere":   # roundoff grows where the quadratic cancels
        c = compare_hits(ro, rd, cen, r, tr, t_w, p_w, t_b, p_b)
        assert c["unexplained"] == 0, c
    else:
        assert np.allclose(t_w[hit], t_b[hit], rtol=1e-5, atol=1e-6)
    assert np.sum(hit & (p_w != p_b)) <= 1


# ------------------------------------------------------------ PNG codec --

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _filtered_png(raster, ftype, ctype):
    """A PNG whose every row uses filter ``ftype`` (the encoder only writes
    filter 0; other encoders choose per row)."""
    h, w, ch = raster.shape
    rows = raster.reshape(h, w * ch).astype(np.int64)
    out = bytearray()
    for y in range(h):
        prev = rows[y - 1] if y else np.zeros(w * ch, np.int64)
        out.append(ftype)
        for x in range(w * ch):
            left = rows[y, x - ch] if x >= ch else 0
            ul = prev[x - ch] if x >= ch else 0
            pred = (0, left, prev[x], (left + prev[x]) // 2,
                    _paeth(left, prev[x], ul))[ftype]
            out.append(int(rows[y, x] - pred) & 0xFF)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decodes_every_filter(ftype):
    raster = np.random.default_rng(ftype).integers(
        0, 256, (7, 9, 3), dtype=np.uint8)
    assert np.array_equal(decode_png(_filtered_png(raster, ftype, 2)), raster)


@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (6, 4)])
def test_png_decodes_grey_and_alpha_to_rgb(ctype, channels):
    raster = np.random.default_rng(9).integers(
        0, 256, (5, 6, channels), dtype=np.uint8)
    rgb = decode_png(_filtered_png(raster, 4, ctype))
    want = (np.repeat(raster[..., :1], 3, -1) if channels < 3
            else raster[..., :3])
    assert np.array_equal(rgb, want)


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (4, 5, 4)])
def test_png_encode_roundtrip(shape):
    raster = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    assert np.array_equal(decode_png(encode_png(raster)), raster[..., :3])


def test_committed_goldens_decode():
    d = os.path.join(ROOT, "tests", "goldens_self")
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            img = decode_png(f.read())
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
        assert img.std() > 0   # a real picture, not a blank decode


# ------------------------------------------------------- chip_smoke.py --

def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    if where == "alone":
        cwd = str(tmp_path)
        with open(os.path.join(ROOT, "chip_smoke.py")) as f, \
                open(os.path.join(cwd, "chip_smoke.py"), "w") as g:
            g.write(f.read())
    else:
        cwd = ROOT
    r = _run_smoke(cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


# ------------------------------------------------------- on the card --

@pytest.mark.gpu
def test_sphere_scan_on_gpu(gpu):
    """At default matmul precision on the card (TF32 may apply to
    products), the scan still meets the f64 oracle."""
    table = _table(_final_world())
    ro, rd = _rays("secondary", table, n=4096)
    t, idx = jax.jit(intersect_spheres)(
        *jax.device_put((jnp.asarray(ro), jnp.asarray(rd), *table), gpu))
    t64, i64 = nearest_hit(ro, rd, *map(np.asarray, table))
    c = compare_hits(ro, rd, *table, t, idx, t64, i64, round_oc=True)
    assert c["unexplained"] == 0, c


@pytest.mark.gpu
def test_persistent_render_matches_wavefront_on_gpu(gpu):
    from learn_path_tracing_tpu.integrator.persistent import render_persistent
    from learn_path_tracing_tpu.integrator.wavefront import render
    from learn_path_tracing_tpu.models import random_scene, stage10_camera

    res = (160, 90)
    wd = jax.device_put(random_scene(seed=20230328).device(), gpu)
    cp = jax.device_put(stage10_camera(res).params(), gpu)
    a, sa = render_persistent(wd, cp, res, spp=4, limit=8, seed=0)
    with jax.default_matmul_precision("highest"):
        b, sb = render(wd, cp, res, spp=4, limit=8, seed=0, hit_backend="xla")
    assert abs(float(sa) - float(sb)) <= 1e-4 * float(sb)
    assert float(jnp.mean(jnp.abs(a - b))) <= 1e-3
