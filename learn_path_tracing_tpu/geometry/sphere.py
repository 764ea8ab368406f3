"""Batched ray-sphere intersection.

Replaces the reference's per-thread linear scan over ``Sphere.field``
(/root/reference/taichi_pathtracer/10_final/world.py:24-33,42-59) with one
``[N, S]`` elementwise evaluation of the reference's per-pair quadratic
(``oc = ro - c`` first, 8_refract/world.py:45-57) followed by a single
min/argmin reduction over the sphere axis, which XLA fuses into one reduce.
No matrix product is involved, so no TF32 rounding can reach ``t`` (the
expanded ``rd @ centers.T`` form loses whole units of ``t`` against the
10,000-radius ground sphere when a GPU runs f32 products in TF32).
geometry/sphere_f64.py is its float64 oracle.

Behavioral parity with the reference:
- nearest hit with ``t >= t_min`` (1e-4), first sphere wins ties;
- if the near root is closer than ``t_min`` and the sphere is transparent,
  the far root is used instead (8_refract/world.py:55-56) — this is what
  lets rays exit glass;
- spheres with radius <= 0 never hit (used for padding).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# plain float, not jnp.float32: a module-level jnp constant would
# initialize the default backend at import time (see core/color.py)
INF = float("inf")
T_MIN = 1e-4


def intersect_spheres(ro, rd, centers, radii, transparency, t_min: float = T_MIN):
    """Nearest-hit scan of ``N`` rays against ``S`` spheres.

    Args:
      ro, rd: ``f32[N,3]`` ray origins / unit directions.
      centers: ``f32[S,3]``; radii: ``f32[S]``; transparency: ``f32[S]``.

    Returns:
      ``(t, idx)``: ``f32[N]`` hit distance (+inf on miss) and ``i32[N]``
      sphere index (arbitrary on miss — mask with ``jnp.isfinite(t)``).
    """
    oc = [ro[:, d:d + 1] - centers[None, :, d] for d in range(3)]  # [N, S]
    half_b = -(oc[0] * rd[:, 0:1] + oc[1] * rd[:, 1:2] + oc[2] * rd[:, 2:3])
    c0 = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - (radii * radii)[None]
    disc = half_b * half_b - c0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t_near = half_b - sq
    t = jnp.where((t_near < t_min) & (transparency[None, :] > 0.0),
                  half_b + sq, t_near)
    valid = (disc >= 0.0) & (t >= t_min) & (radii[None, :] > 0.0)
    t = jnp.where(valid, t, INF)

    # one variadic reduce yields the min and its first index together
    idx = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)

    def first_min(a, b):
        take_b = (b[0] < a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
        return (jnp.where(take_b, b[0], a[0]), jnp.where(take_b, b[1], a[1]))

    t_best, idx_best = jax.lax.reduce(
        (t, idx), (jnp.float32(INF), jnp.int32(2 ** 31 - 1)), first_min, (1,))
    return t_best, jnp.where(jnp.isfinite(t_best), idx_best, 0)


def sphere_normal(point, center, radius):
    """Outward geometric normal at ``point`` on the sphere (normalized)."""
    v = point - center
    n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    return v / jnp.maximum(n, 1e-20)


def sphere_uv(normal):
    """Spherical lat/long UV of a unit normal (legacy texture path,
    15_module.py:864-877 convention: u from atan2(z, x), v from acos(y))."""
    u = 0.5 + jnp.arctan2(normal[..., 2], normal[..., 0]) / (2.0 * jnp.pi)
    v = jnp.arccos(jnp.clip(normal[..., 1], -1.0, 1.0)) / jnp.pi
    return jnp.stack([u, v], axis=-1)
