"""Core SoA value types.

The reference models rays/hits/materials as Taichi structs mutated in place
per GPU thread (/root/reference/taichi_pathtracer/10_final/dtypes.py:1-9).
Here the layout is structure-of-arrays pytrees over a flat ray index,
transformed functionally — every field below is a ``jnp`` array with
a leading wavefront dimension ``[N]``.

The material model is the union of the modern and legacy reference lines:
``metallic`` and ``transparency`` are float (the legacy line treats
``metallic`` as a continuous metal/dielectric mix probability,
15_module.py:997), and ``absorptivity`` is the legacy energy-loss term
(15_module.py:1006-1009); the modern stages simply use {0.0, 1.0} values and
zero absorptivity.
"""

from __future__ import annotations

import jax.numpy as jnp

from .pytree import pytree_dataclass


@pytree_dataclass
class Materials:
    """Material table (or per-ray gathered materials). Leaves: ``[S,...]``."""

    albedo: jnp.ndarray        # f32[S, 3]
    roughness: jnp.ndarray     # f32[S]
    metallic: jnp.ndarray      # f32[S]   (modern: 0/1 dispatch; legacy: mix prob)
    ior: jnp.ndarray           # f32[S]
    transparency: jnp.ndarray  # f32[S]   (0/1)
    absorptivity: jnp.ndarray  # f32[S]   (legacy only; 0 in modern stages)

    @staticmethod
    def stack(mats) -> "Materials":
        """Build a device table from a sequence of host `Material` records."""
        f32 = lambda xs: jnp.asarray(xs, dtype=jnp.float32)
        return Materials(
            albedo=f32([m.albedo for m in mats]).reshape(-1, 3),
            roughness=f32([m.roughness for m in mats]),
            metallic=f32([m.metallic for m in mats]),
            ior=f32([m.ior for m in mats]),
            transparency=f32([m.transparency for m in mats]),
            absorptivity=f32([m.absorptivity for m in mats]),
        )

    def gather(self, idx) -> "Materials":
        """Gather per-ray materials by object index ``idx: i32[N]``."""
        take = lambda a: jnp.take(a, idx, axis=0)
        return Materials(
            albedo=take(self.albedo),
            roughness=take(self.roughness),
            metallic=take(self.metallic),
            ior=take(self.ior),
            transparency=take(self.transparency),
            absorptivity=take(self.absorptivity),
        )


class Material:
    """Host-side scalar material record (scene construction convenience)."""

    __slots__ = ("albedo", "roughness", "metallic", "ior", "transparency", "absorptivity")

    def __init__(self, albedo=(1.0, 1.0, 1.0), roughness=0.0, metallic=0.0,
                 ior=1.5, transparency=0.0, absorptivity=0.0):
        self.albedo = tuple(float(c) for c in albedo)
        self.roughness = float(roughness)
        self.metallic = float(metallic)
        self.ior = float(ior)
        self.transparency = float(transparency)
        self.absorptivity = float(absorptivity)

    def __repr__(self):
        return (f"Material(albedo={self.albedo}, roughness={self.roughness}, "
                f"metallic={self.metallic}, ior={self.ior}, "
                f"transparency={self.transparency}, absorptivity={self.absorptivity})")


@pytree_dataclass
class Rays:
    """A wavefront of rays. ``throughput`` is the reference's ``ray.l``."""

    ro: jnp.ndarray          # f32[N, 3] origin
    rd: jnp.ndarray          # f32[N, 3] unit direction
    throughput: jnp.ndarray  # f32[N, 3]
    alive: jnp.ndarray       # bool[N] — inverse of the reference's ``end`` flag

    @property
    def count(self) -> int:
        return self.ro.shape[0]


@pytree_dataclass
class Hits:
    """Per-ray nearest-hit records (full wavefront width, masked by ``hit``)."""

    t: jnp.ndarray        # f32[N]; +inf on miss
    point: jnp.ndarray    # f32[N, 3]
    normal: jnp.ndarray   # f32[N, 3] — flipped to front-face (see scene.world)
    uv: jnp.ndarray       # f32[N, 2] — texture coordinates (0 for untextured)
    obj: jnp.ndarray      # i32[N] object/primitive index; -1 on miss
    hit: jnp.ndarray      # bool[N]
    material: Materials   # gathered per-ray; ``ior`` already inverted on backface
