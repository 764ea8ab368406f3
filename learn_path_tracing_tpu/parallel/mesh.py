"""Multi-chip rendering over a device mesh.

The reference is single-GPU (SURVEY.md §2.3: no distributed code exists).
The workload's natural parallel axes are:

- ``tile``: data-parallel pixel tiles — zero cross-chip traffic during
  tracing; each device owns a contiguous chunk of the flat pixel axis;
- ``spp``: sample-parallel — each device renders a subset of the samples of
  *every* pixel, reduced with ``psum`` (NCCL over NVLink) at the end.

Because the RNG is counter-based on (absolute pixel id, absolute sample
index), the sharded render computes bit-identical per-sample radiance to the
single-device path; only the cross-device sum order differs (f32 roundoff).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..camera.camera import CameraParams
from ..integrator.persistent import _persistent_core
from ..integrator.wavefront import trace_sample_pixels


def make_mesh(n_tile: int | None = None, n_spp: int = 1, devices=None) -> Mesh:
    """Build a ('tile', 'spp') mesh. Defaults to all devices on the tile axis."""
    devices = list(devices if devices is not None else jax.devices())
    if n_tile is None:
        n_tile = len(devices) // n_spp
    if n_tile * n_spp != len(devices):
        raise ValueError(
            f"mesh {n_tile}x{n_spp} != {len(devices)} devices")
    import numpy as np

    arr = np.array(devices).reshape(n_tile, n_spp)
    return Mesh(arr, ("tile", "spp"))


def render_sharded(world_data, cam: CameraParams, resolution, spp: int,
                   mesh: Mesh, limit: int = 32, seed=0, bsdf: str = "modern",
                   camera_model: str = "thinlens", scene: str = "spheres",
                   hit_backend: str = "auto"):
    """Render across the mesh; returns (image f32[W,H,3] sharded over tiles,
    segments f32 total).

    ``spp`` must divide by the spp-axis size; the pixel axis is padded to a
    tile multiple (padding pixels trace real rays whose results are dropped).
    """
    w, h = resolution
    n = w * h
    n_tile = mesh.shape["tile"]
    n_spp_shards = mesh.shape["spp"]
    if spp % n_spp_shards:
        raise ValueError(f"spp={spp} not divisible by spp axis {n_spp_shards}")
    spp_local = spp // n_spp_shards
    n_pad = -(-n // n_tile) * n_tile

    pixel_ids = jnp.arange(n_pad, dtype=jnp.uint32)
    # padding ids clamp to the last real pixel: valid math, discarded output
    pixel_ids = jnp.minimum(pixel_ids, jnp.uint32(n - 1))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("tile")),
        out_specs=(P("tile"), P()),
        # scan carries mix device-varying (radiance) and invariant (counters)
        # leaves; skip the varying-manual-axes check
        check_vma=False,
    )
    def shard_fn(wd, cp, pix_chunk):
        s0 = jax.lax.axis_index("spp") * spp_local

        def body(k, carry):
            acc, segs = carry
            radiance, segments = trace_sample_pixels(
                wd, cp, resolution, pix_chunk, seed, s0 + k, limit,
                bsdf=bsdf, camera_model=camera_model, scene=scene,
                hit_backend=hit_backend,
            )
            return acc + radiance, segs + segments

        acc0 = jnp.zeros((pix_chunk.shape[0], 3), jnp.float32)
        acc, segs = jax.lax.fori_loop(0, spp_local, body, (acc0, jnp.float32(0.0)))
        acc = jax.lax.psum(acc, "spp")
        segs = jax.lax.psum(segs, ("tile", "spp"))
        return acc, segs

    acc, segs = shard_fn(world_data, cam, pixel_ids)
    img = (acc[:n] / spp).reshape(w, h, 3)
    return img, segs


@partial(jax.jit, static_argnames=("resolution", "spp", "limit", "bsdf",
                                   "camera_model", "scene", "hit_backend", "mesh"))
def _render_sharded_jit(world_data, cam, resolution, spp, mesh, limit, seed,
                        bsdf, camera_model, scene, hit_backend):
    return render_sharded(world_data, cam, resolution, spp, mesh, limit=limit,
                          seed=seed, bsdf=bsdf, camera_model=camera_model,
                          scene=scene, hit_backend=hit_backend)


def render_multichip(world_data, cam: CameraParams, resolution, spp: int,
                     mesh: Mesh, limit: int = 32, seed=0, bsdf: str = "modern",
                     camera_model: str = "thinlens", scene: str = "spheres",
                     hit_backend: str = "auto"):
    """Jitted entry point for multi-chip rendering."""
    return _render_sharded_jit(world_data, cam, resolution, spp, mesh, limit,
                               seed, bsdf, camera_model, scene, hit_backend)


@partial(jax.jit, static_argnames=("resolution", "spp", "limit", "bsdf",
                                   "camera_model", "scene", "hit_backend",
                                   "mesh", "pool_mult", "pool_div",
                                   "drain_ratio"))
def render_persistent_multichip(world_data, cam: CameraParams, resolution,
                                spp: int, mesh: Mesh, limit: int = 32,
                                seed=0, bsdf: str = "modern",
                                camera_model: str = "thinlens",
                                scene: str = "spheres",
                                hit_backend: str = "auto",
                                pool_mult: int = 0, pool_div: int = 0,
                                drain_ratio: int = 8):
    """Tile/spp-sharded persistent integrator (the fast path, multi-chip).

    Each device runs integrator.persistent._persistent_core over its own
    pixel range (tile axis) and sample range (spp axis): the item schedule,
    drain-cascade argsort compaction and one-hot accumulation are all
    shard-local, so there is ZERO cross-chip traffic during tracing — one
    ``psum`` folds the spp axis and the tile gather assembles the image at
    the very end (one image-sized all-gather equivalent).
    Per-sample radiance is bit-identical to the single-chip path (counter
    RNG on absolute pixel/sample ids); per-pixel sums differ only in f32
    association order, and traced segment counts match exactly.
    """
    w, h = resolution
    n = w * h
    n_tile = mesh.shape["tile"]
    n_spp_shards = mesh.shape["spp"]
    if n % n_tile:
        raise ValueError(
            f"persistent sharding needs tile axis {n_tile} to divide "
            f"n={n} pixels (pad the resolution)")
    if spp % n_spp_shards:
        raise ValueError(f"spp={spp} not divisible by spp axis {n_spp_shards}")
    n_local = n // n_tile
    spp_local = spp // n_spp_shards

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P("tile"), P()),
        check_vma=False,
    )
    def shard_fn(wd, cp):
        pixel_base = jnp.uint32(jax.lax.axis_index("tile")) * jnp.uint32(n_local)
        sample_base = (jnp.uint32(jax.lax.axis_index("spp"))
                       * jnp.uint32(spp_local))
        acc, segs = _persistent_core(
            wd, cp, resolution, n_local, pixel_base, sample_base, spp_local,
            limit, seed, bsdf, camera_model, scene, hit_backend,
            pool_mult, pool_div, drain_ratio, stats=False)
        acc = jax.lax.psum(acc, "spp")
        segs = jax.lax.psum(segs, ("tile", "spp"))
        return acc, segs

    acc, segs = shard_fn(world_data, cam)
    img = (acc / spp).reshape(w, h, 3)
    return img, segs


def render_hybrid_multichip(world_data, cam: CameraParams, resolution,
                            spp: int, mesh: Mesh, limit: int = 32,
                            seed=0, bsdf: str = "legacy",
                            camera_model: str = "jitter",
                            scene: str = "legacy",
                            hit_backend: str = "auto",
                            chunk_spp: int = 0, cap: int = 0,
                            pool_w: int = 0, drain_ratio: int = 2):
    """Tile/spp-sharded hybrid integrator (the fast mesh path, multi-chip).

    Each device runs integrator.hybrid._hybrid_core over its own pixel
    range (tile axis) and sample range (spp axis): phase-A slabs, the
    shared survivor pool, merges and deposits are all shard-local — ZERO
    cross-chip traffic while tracing; one ``psum`` folds the spp axis and
    the tile gather assembles the image at the end (same communication
    shape as render_persistent_multichip). Per-sample radiance is
    bit-identical to the single-chip hybrid (counter RNG on absolute
    pixel/sample ids); per-pixel sums differ only in f32 association
    order, and traced segment counts match exactly.
    """
    from ..integrator.hybrid import _hybrid_core

    w, h = resolution
    n = w * h
    n_tile = mesh.shape["tile"]
    n_spp_shards = mesh.shape["spp"]
    if n % n_tile:
        raise ValueError(
            f"hybrid sharding needs tile axis {n_tile} to divide "
            f"n={n} pixels (pad the resolution)")
    if spp % n_spp_shards:
        raise ValueError(f"spp={spp} not divisible by spp axis {n_spp_shards}")
    n_local = n // n_tile
    spp_local = spp // n_spp_shards

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P("tile"), P()),
        check_vma=False,
    )
    def shard_fn(wd, cp):
        pixel_base = (jnp.uint32(jax.lax.axis_index("tile"))
                      * jnp.uint32(n_local))
        sample_base = (jnp.uint32(jax.lax.axis_index("spp"))
                       * jnp.uint32(spp_local))
        acc, segs = _hybrid_core(
            wd, cp, resolution, n_local, pixel_base, sample_base, spp_local,
            limit, seed, bsdf, camera_model, scene, hit_backend,
            chunk_spp, cap, pool_w, drain_ratio, stats=False)
        acc = jax.lax.psum(acc, "spp")
        segs = jax.lax.psum(segs, ("tile", "spp"))
        return acc, segs

    acc, segs = shard_fn(world_data, cam)
    img = (acc / spp).reshape(w, h, 3)
    return img, segs
