"""Monte-Carlo sampling primitives (batched, branchless).

Distributions match the reference's ``ti.func`` samplers
(/root/reference/taichi_pathtracer/8_refract/bsdf.py:5-59 and
9_dof/camera.py:29-35), re-expressed as pure vectorized functions that take
their uniforms explicitly (counter-based RNG) and operate on ``f32[N,3]``
batches. All conditionals are ``jnp.where`` selects — no per-lane control
flow, so everything fuses into wide VPU ops.
"""

from __future__ import annotations

import jax.numpy as jnp

TWO_PI = 6.283185307179586


def dot(a, b):
    """Batched dot product over the last axis, keeping dims: f32[N,1]."""
    return jnp.sum(a * b, axis=-1, keepdims=True)


def normalize(v, eps: float = 0.0):
    n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    if eps:
        n = jnp.maximum(n, eps)
    return v / n


def sample_at_sphere(u1, u2):
    """Uniform direction on the unit sphere. ``u1,u2: f32[N]`` → ``f32[N,3]``."""
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    theta = TWO_PI * u2
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), z], axis=-1)


def ball_radius(u1, u2, u3):
    """Radius of a uniform in-ball point from three uniforms: ``max(u1,u2,u3)``
    has CDF r³ — exactly the cbrt(U) distribution — without ``jnp.cbrt``
    (XLA lowers it through the generic pow/exp-log path); extra counter-RNG
    uniforms are ~free."""
    return jnp.maximum(u1, jnp.maximum(u2, u3))


def sample_in_sphere(u1, u2, u3):
    """Uniform point inside the unit ball (legacy roughness perturbation,
    15_module.py:295-306 semantics: direction uniform, radius ∝ cbrt(u))."""
    d = sample_at_sphere(u1, u2)
    r = jnp.cbrt(u3)
    return d * r[..., None]


def sample_in_disk(u1, u2):
    """Uniform point in the unit disk → ``f32[N,2]`` (thin-lens aperture)."""
    r = jnp.sqrt(u1)
    theta = TWO_PI * u2
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def sample_lambertian(normal, u1, u2):
    """Cosine-weighted bounce: normalize(normal + uniform-on-sphere)."""
    return normalize(normal + sample_at_sphere(u1, u2), eps=1e-12)


def slerp(a, b, t):
    """Spherical lerp between unit vectors; linear fallback when nearly
    parallel (sin ω < 1e-6), then re-normalized — mirrors 7_reflect/bsdf.py:21-27.

    Transcendental-lean form (this runs per lane per bounce): sin ω comes
    from √(1−cos²ω) and sin((1−t)ω) expands via the angle-difference
    identity, so the whole slerp costs one arccos + one sin + one cos
    instead of one arccos + three sins. Identical math in exact arithmetic.
    """
    cosw = jnp.clip(dot(a, b), -1.0, 1.0)
    omega = jnp.arccos(cosw)
    so = jnp.sqrt(jnp.maximum(1.0 - cosw * cosw, 0.0))  # sin ω, ω ∈ [0, π]
    t = jnp.asarray(t)
    if t.ndim < a.ndim:
        t = t[..., None]
    safe_so = jnp.where(so < 1e-6, 1.0, so)
    sin_tw = jnp.sin(t * omega)
    cos_tw = jnp.cos(t * omega)
    # sin((1-t)ω)/sinω = cos(tω) − cosω·sin(tω)/sinω
    s_a = cos_tw - cosw * sin_tw / safe_so
    s_b = sin_tw / safe_so
    lin = (1.0 - t) * a + t * b
    sph = s_a * a + s_b * b
    return normalize(jnp.where(so < 1e-6, lin, sph), eps=1e-12)


def reflect(d, n):
    """Mirror reflection of direction ``d`` about normal ``n``."""
    return d - 2.0 * dot(d, n) * n


def sample_normal(d, n, roughness, u1, u2):
    """Roughness-perturbed shading normal (7_reflect/bsdf.py:30-37): slerp the
    mirror direction toward a cosine-weighted sample by roughness², then take
    the half-way normal between incoming and perturbed outgoing directions."""
    s = sample_lambertian(n, u1, u2)
    r = reflect(d, n)
    r = slerp(r, s, (roughness * roughness))
    return normalize(r - d, eps=1e-12)


def refract(d, n, ior):
    """Snell refraction of unit ``d`` through normal ``n`` with relative index
    ``ior`` (outside→inside); falls back to mirror reflection on total internal
    reflection — 8_refract/bsdf.py:47-59."""
    ior = jnp.asarray(ior)
    if ior.ndim < d.ndim:
        ior = ior[..., None]
    k = dot(d, n)
    r_perp = (d - k * n) / ior
    perp_len2 = dot(r_perp, r_perp)
    kk = jnp.sqrt(jnp.maximum(1.0 - perp_len2, 0.0))
    refracted = r_perp - kk * n
    return jnp.where(perp_len2 > 1.0, reflect(d, n), refracted)


def schlick(cos_theta, f0):
    """Schlick fresnel approximation: F0 + (1-F0)(1-cosθ)⁵.

    The fifth power is spelled as explicit squaring (three multiplies)
    rather than ``x ** 5``, which XLA may lower through the generic pow
    path (exp/log)."""
    c = jnp.maximum(cos_theta, 0.0)
    m = 1.0 - c
    m2 = m * m
    return f0 + (1.0 - f0) * (m2 * m2 * m)


def refract_legacy(d, n, ior):
    """Legacy refraction (15_module.py:320-331): like `refract` but with the
    perpendicular component clamped to length 1 instead of a TIR fallback —
    grazing/TIR rays exit along the tangent direction."""
    ior = jnp.asarray(ior)
    if ior.ndim < d.ndim:
        ior = ior[..., None]
    k = dot(d, n)
    r_perp = (d - k * n) / ior
    perp_len2 = jnp.minimum(dot(r_perp, r_perp), 1.0)
    kk = jnp.sqrt(jnp.maximum(1.0 - perp_len2, 0.0))
    return r_perp - kk * n


def roughen(direction, roughness, u1, u2, u3):
    """Legacy roughness perturbation (15_module.py:334-347): add
    roughness-scaled uniform-in-ball jitter, then normalize."""
    s = sample_in_sphere(u1, u2, u3)
    r = jnp.asarray(roughness)
    if r.ndim < direction.ndim:
        r = r[..., None]
    return normalize(direction + r * s, eps=1e-12)
