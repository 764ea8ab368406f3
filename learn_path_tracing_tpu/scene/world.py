"""Sphere-scene container: host-side builder + device SoA tables + hit query.

Mirrors the reference ``World``/``Sphere`` API
(/root/reference/taichi_pathtracer/10_final/world.py) split into:

- ``Sphere`` / ``World``: host-side scene construction (python lists, growable
  like the reference's capacity-doubling field, but trivially so);
- ``SphereWorldData``: a frozen SoA pytree of device arrays, padded to a
  fixed multiple, produced by ``World.device()`` and fed to jitted render functions;
- ``hit(world_data, rays)``: the pure wavefront nearest-hit query, including
  the reference's back-face handling (flip normal, invert ior —
  8_refract/world.py:31-33, present from stage 8 on; harmless for earlier
  stages where rays never start inside a sphere).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.pytree import pytree_dataclass
from ..core.types import Hits, Material, Materials, Rays
from ..geometry.sphere import intersect_spheres, sphere_normal

_PAD = 128  # pad sphere tables to a fixed multiple (fewer distinct shapes)


class Sphere:
    """Host-side sphere record. ``material`` may be a Material, an RGB tuple
    (stage-6 style albedo shorthand), or None (stages 4-5 normal shading)."""

    __slots__ = ("center", "radius", "material")

    def __init__(self, center, radius, material=None):
        self.center = tuple(float(c) for c in center)
        self.radius = float(radius)
        if material is None:
            material = Material()
        elif not isinstance(material, Material):
            material = Material(albedo=material)  # albedo shorthand
        self.material = material


@pytree_dataclass
class SphereWorldData:
    centers: jnp.ndarray       # f32[S,3] (padded; radius==0 marks padding)
    radii: jnp.ndarray         # f32[S]
    materials: Materials       # leaves [S,...]
    bvh: object = None         # FlatBVH | None (legacy 11_bvh-style accel)


class World:
    """Growable sphere scene (mirrors 10_final/world.py World.add)."""

    def __init__(self, spheres=()):
        self.spheres: list[Sphere] = list(spheres)
        self._cache: SphereWorldData | None = None

    def add(self, sphere: Sphere) -> None:
        self.spheres.append(sphere)
        self._cache = None

    @property
    def size(self) -> int:
        return len(self.spheres)

    def device(self, use_bvh: bool = False) -> SphereWorldData:
        """Upload the scene as padded SoA device arrays (cached).

        ``use_bvh=True`` additionally builds the legacy-line SAH sphere BVH
        (11_bvh.py) enabling ``hit(..., backend='bvh')``.
        """
        if self._cache is None or (use_bvh and self._cache.bvh is None):
            n = len(self.spheres)
            if n == 0:
                raise ValueError("empty world")
            padded = -(-n // _PAD) * _PAD
            centers = np.zeros((padded, 3), np.float32)
            radii = np.zeros((padded,), np.float32)
            for k, s in enumerate(self.spheres):
                centers[k] = s.center
                radii[k] = s.radius
            mats = [s.material for s in self.spheres]
            mats += [Material()] * (padded - n)
            bvh = None
            if use_bvh:
                from ..accel.bvh import build_bvh

                c = centers[:n]
                r = radii[:n, None]
                bvh = build_bvh(c - r, c + r, centroid=c, max_depth=8,
                                max_leaf=4)
            self._cache = SphereWorldData(
                centers=jnp.asarray(centers),
                radii=jnp.asarray(radii),
                materials=Materials.stack(mats),
                bvh=bvh,
            )
        return self._cache


def hit(world: SphereWorldData, rays: Rays, t_min: float = 1e-4,
        backend: str = "auto") -> Hits:
    """Nearest-hit of a ray wavefront against the sphere table.

    ``backend``: 'auto' / 'xla' run the XLA per-pair scan
    (geometry/sphere.py); 'bvh' walks the sphere BVH (accel/traverse.py).
    """
    if backend not in ("auto", "xla", "bvh"):
        raise ValueError(f"unknown hit backend {backend!r}")
    if backend == "bvh":
        from ..accel.traverse import make_sphere_leaf_test, traverse

        if world.bvh is None:
            raise ValueError("World.device(use_bvh=True) required for 'bvh'")
        lt = make_sphere_leaf_test(world.centers, world.radii,
                                   world.materials.transparency, eps=t_min)
        t, idx = traverse(world.bvh, rays.ro, rays.rd, lt, eps=t_min)
        idx = jnp.maximum(idx, 0)
    else:
        t, idx = intersect_spheres(
            rays.ro, rays.rd, world.centers, world.radii,
            world.materials.transparency, t_min=t_min,
        )

    hit_mask = jnp.isfinite(t)
    t_safe = jnp.where(hit_mask, t, 0.0)
    point = rays.ro + t_safe[:, None] * rays.rd
    center = jnp.take(world.centers, idx, axis=0)
    radius = jnp.take(world.radii, idx, axis=0)
    normal = sphere_normal(point, center, radius)

    mat = world.materials.gather(idx)
    # Back-face: flip the normal and invert the relative ior so refraction
    # exits the medium correctly (8_refract/world.py:31-33).
    backface = jnp.sum(rays.rd * normal, axis=-1) > 0.0
    normal = jnp.where(backface[:, None], -normal, normal)
    ior = jnp.where(backface, 1.0 / mat.ior, mat.ior)
    mat = Materials(
        albedo=mat.albedo, roughness=mat.roughness, metallic=mat.metallic,
        ior=ior, transparency=mat.transparency, absorptivity=mat.absorptivity,
    )

    return Hits(
        t=t,
        point=point,
        normal=normal,
        uv=jnp.zeros((rays.count, 2), jnp.float32),
        obj=jnp.where(hit_mask, idx, -1),
        hit=hit_mask,
        material=mat,
    )
