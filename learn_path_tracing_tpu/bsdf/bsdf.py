"""BSDF scatter functions over ray wavefronts.

Semantics mirror /root/reference/taichi_pathtracer/8_refract/bsdf.py:62-110
(identical in stages 9/10) but evaluated branchlessly over ``f32[N,3]``
batches: both the metal and dielectric lobes are computed for every lane and
the result is selected with ``jnp.where`` — no divergence scheme, and it
is exactly how the reference's warp-divergent
dispatch behaves distribution-wise.

Key behavioral details preserved:
- Fresnel is evaluated against the roughness-perturbed normal ``n`` for both
  metal (F0 = albedo) and dielectric (F0 = ((ior-1)/(ior+1))²).
- The dielectric's diffuse branch samples about the *geometric* hit normal,
  not the perturbed one (8_refract/bsdf.py:106).
- New ray origin is the hit point with no epsilon offset; self-intersection
  is avoided by the t ≥ 1e-4 test in the world scan.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import rng
from ..core.types import Hits, Rays
from . import sampling as sp


def scatter_diffuse(rays: Rays, hits: Hits, base) -> Rays:
    """Stage-6 Lambertian-only scatter (6_diffuse/bsdf.py:20-26)."""
    u1, u2 = rng.uniform2(base, 0)
    rd = sp.sample_lambertian(hits.normal, u1, u2)
    return Rays(
        ro=hits.point,
        rd=rd,
        throughput=rays.throughput * hits.material.albedo,
        alive=rays.alive,
    )


def scatter_modern(rays: Rays, hits: Hits, base) -> Rays:
    """Stages 7-10 dispatch: metallic==1 → metal, else dielectric."""
    d = rays.rd
    mat = hits.material
    u1, u2 = rng.uniform2(base, 0)
    u_roulette = rng.uniform(base, 2)
    u3, u4 = rng.uniform2(base, 3)

    n = sp.sample_normal(d, hits.normal, mat.roughness[..., None], u1, u2)
    cos_theta = jnp.maximum(jnp.sum(n * (-d), axis=-1), 0.0)

    # Metal lobe: tinted fresnel attenuation, mirror about perturbed normal.
    f_metal = sp.schlick(cos_theta[..., None], mat.albedo)
    rd_metal = sp.reflect(d, n)
    l_metal = rays.throughput * f_metal

    # Dielectric lobe: scalar Schlick roulette between specular reflection and
    # (refraction if transparent else diffuse), tinting only the non-specular path.
    f0 = ((mat.ior - 1.0) / (mat.ior + 1.0)) ** 2
    f_diel = sp.schlick(cos_theta, f0)
    rd_refract = sp.refract(d, n, mat.ior)
    rd_diffuse = sp.sample_lambertian(hits.normal, u3, u4)
    transmit = u_roulette > f_diel
    is_transparent = mat.transparency > 0.0
    rd_nonspec = jnp.where(is_transparent[..., None], rd_refract, rd_diffuse)
    rd_diel = jnp.where(transmit[..., None], rd_nonspec, sp.reflect(d, n))
    l_diel = jnp.where(
        transmit[..., None], rays.throughput * mat.albedo, rays.throughput
    )

    is_metal = (mat.metallic == 1.0)[..., None]
    return Rays(
        ro=hits.point,
        rd=jnp.where(is_metal, rd_metal, rd_diel),
        throughput=jnp.where(is_metal, l_metal, l_diel),
        alive=rays.alive,
    )


def scatter_legacy(rays: Rays, hits: Hits, base) -> Rays:
    """Legacy wavefront scatter (15_module.py:994-1013):

    - continuous ``metallic`` is a stochastic metal/dielectric mix prob;
    - metal: tinted Schlick, mirror about the *geometric* normal, additive
      in-ball roughness jitter (no slerp);
    - dielectric roulette: transmit → legacy refract (clamped, no TIR) or
      diffuse, both attenuated by ``albedo * (1 - absorptivity)``; specular
      reflection leaves throughput unchanged;
    - new origin offset 2ε along the shading normal.
    """
    d = rays.rd
    nrm = hits.normal
    mat = hits.material

    u_metal = rng.uniform(base, 0)
    u1, u2, u3 = rng.uniform3(base, 1)   # sphere point + ball radius
    u_fresnel = rng.uniform(base, 4)
    u4, u5 = rng.uniform2(base, 5)       # ball radius, cont.

    # One uniform-on-sphere point serves every branch: the in-ball jitter
    # direction (reflect/refract roughening) and the Lambertian offset.
    # Per lane exactly ONE outgoing direction is consumed (metal-reflect,
    # diel-specular-reflect, diel-refract, or diel-diffuse are mutually
    # exclusive), and branch selection uses independent uniforms
    # (u_metal/u_fresnel), so each consumed sample is still an independent
    # uniform sphere draw — the distribution is unchanged while the pass
    # saves a second sin/cos pair. The in-ball radius is max(u3,u4,u5) —
    # the exact cbrt(U) law without jnp.cbrt (sampling.ball_radius).
    s_sphere = sp.sample_at_sphere(u1, u2)
    ball = s_sphere * sp.ball_radius(u3, u4, u5)[..., None]

    def _roughen(direction):
        return sp.normalize(direction + mat.roughness[..., None] * ball,
                            eps=1e-12)

    cos_theta = jnp.maximum(jnp.sum(nrm * (-d), axis=-1), 0.0)
    rd_reflect = _roughen(sp.reflect(d, nrm))

    # metal branch
    f_metal = sp.schlick(cos_theta[..., None], mat.albedo)
    l_metal = rays.throughput * f_metal

    # dielectric branch
    f0 = ((mat.ior - 1.0) / (mat.ior + 1.0)) ** 2
    f_diel = sp.schlick(cos_theta, f0)
    rd_refract = _roughen(sp.refract_legacy(d, nrm, mat.ior))
    rd_diffuse = sp.normalize(nrm + s_sphere, eps=1e-12)
    attenuation = mat.albedo * (1.0 - mat.absorptivity)[..., None]
    transmit = u_fresnel > f_diel
    is_transparent = mat.transparency > 0.0
    rd_nonspec = jnp.where(is_transparent[..., None], rd_refract, rd_diffuse)
    rd_diel = jnp.where(transmit[..., None], rd_nonspec, rd_reflect)
    l_diel = jnp.where(transmit[..., None], rays.throughput * attenuation,
                       rays.throughput)

    is_metal = (u_metal < mat.metallic)[..., None]
    return Rays(
        ro=hits.point + 2.0 * 1e-4 * nrm,
        rd=jnp.where(is_metal, rd_reflect, rd_diel),
        throughput=jnp.where(is_metal, l_metal, l_diel),
        alive=rays.alive,
    )


SCATTERERS = {
    "diffuse": scatter_diffuse,
    "modern": scatter_modern,
    "legacy": scatter_legacy,
}
