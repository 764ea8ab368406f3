"""Masked-wavefront path-tracing integrator.

The reference's megakernel walks up to ``propagate_limit`` bounces per GPU
thread with an early ``break`` (10_final/__main__.py:78-87). Here the
integrator is a loop over bounce passes across the whole flat wavefront
with an ``alive`` mask — the structure of the legacy wavefront line
(15_module.py:1029-1035). It is the plain reference the faster integrators
(persistent, hybrid) are checked against.

Radiance accounting matches the reference exactly: a path contributes
``background(rd) * throughput`` only if it escapes the scene within the
bounce budget; paths that exhaust the budget contribute nothing
(10_final/__main__.py:84-87).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..bsdf.bsdf import SCATTERERS
from ..camera.camera import CameraParams, generate_rays_for_pixels, pixel_grid
from ..core import rng
from ..core.pytree import tree_where
from ..scene import world as world_mod


def sky_background(rd):
    """White→blue vertical gradient (10_final/__main__.py:58-62)."""
    t = 0.5 * (rd[..., 1] + 1.0)
    white = jnp.array([1.0, 1.0, 1.0], jnp.float32)
    blue = jnp.array([0.5, 0.7, 1.0], jnp.float32)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def _scene_fns(scene: str):
    """(hit_fn(world, rays, backend), background_fn(world, rd)) per scene kind.

    'spheres': the modern-stage sphere world with the gradient sky.
    'legacy' : textured mesh/sphere BVH world with equirect IBL escape.
    """
    if scene == "spheres":
        return (lambda w, r, hb: world_mod.hit(w, r, backend=hb),
                lambda w, rd, mask=None: sky_background(rd))
    if scene == "legacy":
        from ..scene.legacy_world import environment_color, hit_legacy

        return (lambda w, r, hb: hit_legacy(w, r),
                lambda w, rd, mask=None: environment_color(
                    w.envs, w.env_id, rd, mask=mask,
                    gradient_h=getattr(w, "env_gradient_h", None)))
    raise ValueError(f"unknown scene kind: {scene!r}")


def trace_sample_pixels(world_data, cam: CameraParams, resolution, pixel_ids,
                        seed, sample, limit: int, bsdf: str = "modern",
                        camera_model: str = "thinlens",
                        scene: str = "spheres", hit_backend: str = "auto",
                        early_exit: bool = True):
    """Trace one sample for each absolute pixel id; returns
    (radiance f32[N,3], segments f32). RNG keys on absolute pixel ids, so a
    sharded pixel chunk computes exactly what the single-device path would.

    ``early_exit=True`` runs the bounce loop as a ``while_loop`` that stops
    as soon as every lane is dead — bitwise-identical radiance to the fixed
    ``limit``-pass scan (the skipped passes are all-masked no-ops), but the
    reference's 32-pass budget typically ends after a handful of live passes.
    """
    rays = generate_rays_for_pixels(cam, resolution, pixel_ids, seed, sample,
                                    model=camera_model)
    n = rays.count
    scatter = SCATTERERS[bsdf]
    hit_fn, background_fn = _scene_fns(scene)
    pix = pixel_ids.astype(jnp.uint32)

    def bounce_step(b, rays, radiance, segments):
        hits = hit_fn(world_data, rays, hit_backend)
        # f32 counter: exact to 2^24 per pass, ample precision for a rate metric
        segments = segments + jnp.sum(rays.alive.astype(jnp.float32))

        escaped = rays.alive & ~hits.hit
        radiance = radiance + jnp.where(
            escaped[:, None],
            background_fn(world_data, rays.rd, escaped) * rays.throughput,
            0.0,
        )

        base = rng.base(rng.stream(seed, sample, b, rng.STREAM_BSDF), pix)
        scattered = scatter(rays, hits, base)
        survived = rays.alive & hits.hit
        rays = tree_where(survived, scattered, rays)
        rays = type(rays)(ro=rays.ro, rd=rays.rd, throughput=rays.throughput,
                          alive=survived)
        return rays, radiance, segments

    radiance0 = jnp.zeros((n, 3), jnp.float32)
    if early_exit:
        def cond(state):
            b, rays, _, _ = state
            return (b < limit) & jnp.any(rays.alive)

        def body(state):
            b, rays, radiance, segments = state
            rays, radiance, segments = bounce_step(
                b.astype(jnp.uint32), rays, radiance, segments)
            return b + 1, rays, radiance, segments

        _, rays, radiance, segments = jax.lax.while_loop(
            cond, body, (jnp.int32(0), rays, radiance0, jnp.float32(0.0)))
    else:
        def scan_body(carry, b):
            rays, radiance, segments = carry
            return bounce_step(b, rays, radiance, segments), None

        (rays, radiance, segments), _ = jax.lax.scan(
            scan_body, (rays, radiance0, jnp.float32(0.0)),
            jnp.arange(limit, dtype=jnp.uint32),
        )
    return radiance, segments


def trace_sample(world_data, cam: CameraParams, resolution, seed, sample,
                 limit: int, bsdf: str = "modern", camera_model: str = "thinlens",
                 scene: str = "spheres", hit_backend: str = "auto",
                 early_exit: bool = True):
    """Trace one sample per pixel over the full pixel grid."""
    return trace_sample_pixels(
        world_data, cam, resolution, pixel_grid(resolution), seed, sample,
        limit, bsdf=bsdf, camera_model=camera_model, scene=scene,
        hit_backend=hit_backend, early_exit=early_exit,
    )


@partial(jax.jit, static_argnames=("resolution", "spp", "limit", "bsdf",
                                   "camera_model", "scene", "hit_backend",
                                   "early_exit"))
def render(world_data, cam: CameraParams, resolution, spp: int, limit: int = 32,
           seed=0, bsdf: str = "modern", camera_model: str = "thinlens",
           scene: str = "spheres", hit_backend: str = "auto",
           early_exit: bool = True):
    """Render ``spp`` samples/pixel; returns (image f32[W,H,3], segments).

    The image is mean linear radiance (the reference divides each
    contribution by spp; identical result). ``segments`` counts live ray
    segments actually traced — the Mrays metric numerator.
    """
    w, h = resolution

    def body(s, carry):
        acc, segs = carry
        radiance, segments = trace_sample(
            world_data, cam, resolution, seed, s, limit,
            bsdf=bsdf, camera_model=camera_model, scene=scene,
            hit_backend=hit_backend, early_exit=early_exit,
        )
        return acc + radiance, segs + segments

    acc0 = jnp.zeros((w * h, 3), jnp.float32)
    segs0 = jnp.float32(0.0)
    acc, segs = jax.lax.fori_loop(0, spp, body, (acc0, segs0))
    img = (acc / spp).reshape(w, h, 3)
    return img, segs


@partial(jax.jit, static_argnames=("resolution", "spp_per_call", "limit", "bsdf",
                                   "camera_model", "scene", "hit_backend",
                                   "early_exit"))
def render_accumulate(world_data, cam: CameraParams, acc, sample_start,
                      resolution, spp_per_call: int, limit: int = 32, seed=0,
                      bsdf: str = "modern", camera_model: str = "thinlens",
                      scene: str = "spheres", hit_backend: str = "auto",
                      early_exit: bool = True):
    """Progressive variant: add ``spp_per_call`` samples into ``acc`` [N,3]
    starting at absolute sample index ``sample_start``.
    Returns (new acc, ray segments traced this call)."""

    def body(k, carry):
        a, segs = carry
        radiance, segments = trace_sample(
            world_data, cam, resolution, seed, sample_start + k, limit,
            bsdf=bsdf, camera_model=camera_model, scene=scene,
            hit_backend=hit_backend, early_exit=early_exit,
        )
        return a + radiance, segs + segments

    return jax.lax.fori_loop(0, spp_per_call, body, (acc, jnp.float32(0.0)))


def render_chunked(world_data, cam: CameraParams, resolution, spp: int,
                   limit: int = 32, seed=0, chunk_spp: int = 8,
                   bsdf: str = "modern", camera_model: str = "thinlens",
                   scene: str = "spheres", hit_backend: str = "auto",
                   early_exit: bool = True):
    """Host-chunked render: dispatches the spp loop in ``chunk_spp``-sample
    ``render_accumulate`` calls (the progressive viewer's unit of work).
    Functionally identical to ``render`` (same RNG counters).
    Returns (image f32[W,H,3], segments f32 scalar array)."""
    w, h = resolution
    acc = jnp.zeros((w * h, 3), jnp.float32)
    segs_total = jnp.float32(0.0)
    for s0 in range(0, spp, chunk_spp):
        n_call = min(chunk_spp, spp - s0)
        acc, segs = render_accumulate(
            world_data, cam, acc, jnp.uint32(s0), resolution, n_call,
            limit=limit, seed=seed, bsdf=bsdf, camera_model=camera_model,
            scene=scene, hit_backend=hit_backend, early_exit=early_exit)
        segs_total = segs_total + segs
    return (acc / spp).reshape(w, h, 3), segs_total
