"""Shared plumbing for the staged tutorial scripts.

Each stage module mirrors one reference stage
(/root/reference/taichi_pathtracer/<stage>/__main__.py): same scene, camera,
resolution and spp defaults, same output filename under ``outputs/``.
Run as ``python -m learn_path_tracing_tpu.stages.s06_diffuse [--spp N] ...``.
"""

from __future__ import annotations

import argparse
import functools
import time

import jax
import jax.numpy as jnp

from ..camera.camera import CameraParams, generate_rays
from ..core import color, image
from ..integrator.persistent import render_persistent
from ..integrator.wavefront import sky_background
from ..scene import world as world_mod
from ..utils.config import RenderConfig
from ..utils.runtime import enable_compile_cache


def parse_args(cfg: RenderConfig, description="") -> RenderConfig:
    """CLI over a stage's RenderConfig preset; returns the merged config."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--width", type=int, default=cfg.width)
    p.add_argument("--height", type=int, default=cfg.height)
    p.add_argument("--spp", type=int, default=cfg.spp)
    p.add_argument("--out", type=str, default=cfg.out)
    p.add_argument("--limit", type=int, default=cfg.propagate_limit,
                   help="bounce limit")
    p.add_argument("--seed", type=int, default=cfg.seed)
    p.add_argument("--platform", type=str, default=None,
                   help="force a jax platform (e.g. cpu)")
    p.add_argument("--hit-backend", type=str, default=cfg.hit_backend,
                   choices=["auto", "xla", "bvh"])
    a = p.parse_args()
    if a.platform:
        jax.config.update("jax_platforms", a.platform)
    enable_compile_cache()
    return cfg.with_(width=a.width, height=a.height, spp=a.spp, out=a.out,
                     propagate_limit=a.limit, seed=a.seed,
                     hit_backend=a.hit_backend)


@functools.partial(jax.jit, static_argnames=("resolution", "camera_model"))
def render_normal_shaded(world_data, cam: CameraParams, resolution,
                         camera_model: str = "center"):
    """Primary-ray visualization used by stages 3-5: hit → 0.5*(normal+1),
    miss → sky gradient (3_adding_a_sphere/__main__.py:27-40)."""
    rays = generate_rays(cam, resolution, 0, 0, model=camera_model)
    hits = world_mod.hit(world_data, rays)
    col = jnp.where(
        hits.hit[:, None], 0.5 * (hits.normal + 1.0), sky_background(rays.rd)
    )
    w, h = resolution
    return col.reshape(w, h, 3)


@functools.partial(jax.jit, static_argnames=("resolution", "spp", "camera_model"))
def render_normal_shaded_aa(world_data, cam: CameraParams, resolution, spp: int,
                            camera_model: str = "thinlens"):
    """Stage 5: jittered primary rays accumulated over spp."""

    def body(s, acc):
        rays = generate_rays(cam, resolution, 0, s, model=camera_model)
        hits = world_mod.hit(world_data, rays)
        col = jnp.where(
            hits.hit[:, None], 0.5 * (hits.normal + 1.0), sky_background(rays.rd)
        )
        return acc + col

    w, h = resolution
    acc = jax.lax.fori_loop(0, spp, body, jnp.zeros((w * h, 3), jnp.float32))
    return (acc / spp).reshape(w, h, 3)


def run_path_traced(world, camera, cfg: RenderConfig, out_name,
                    post=True):
    """Timed full render + post-process + PNG write (the render() pattern of
    10_final/__main__.py:99-118), as one device call."""
    res = (cfg.width, cfg.height)
    start = time.time()
    img, segs = render_persistent(
        world.device(), camera.params(), res, spp=cfg.spp,
        limit=cfg.propagate_limit, seed=cfg.seed, bsdf=cfg.bsdf,
        scene=cfg.scene, camera_model=cfg.camera_model,
        hit_backend=cfg.hit_backend)
    if post:
        img = jax.jit(color.post_process)(img)
    img = jax.block_until_ready(img)
    elapsed = time.time() - start
    segs = float(segs)
    mrays = segs / max(elapsed, 1e-9) / 1e6
    print(f"Time elapsed: {elapsed:.2f}s  ({segs:.3e} ray segments, "
          f"{mrays:.1f} Mrays/s, {jax.devices()[0].device_kind})")

    out = cfg.out or f"outputs/{out_name}"
    image.write_png(img, out)
    print(f"wrote {out}")
    return img
