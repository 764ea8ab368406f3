"""Counter-based (stateless) RNG for Monte-Carlo sampling on the device.

The reference tracer uses Taichi's stateful per-thread ``ti.random()``
(e.g. /root/reference/taichi_pathtracer/10_final/camera.py:85), which is
neither reproducible nor shardable. Here every random number is a pure
function of ``(seed, sample, bounce, stream, pixel, dim)`` — a PCG-style
integer hash evaluated on the VPU — so renders are bit-deterministic and
invariant under pixel-tile / spp resharding across a device mesh, and the
identical construction can be re-implemented inside Pallas kernels.

Quality: one PCG-RXS-M-XS permutation per fold, with multiple folds between
correlated counters. Passes mean/variance/correlation tests (see
tests/test_rng.py); ample for Monte-Carlo rendering.
"""

from __future__ import annotations

import jax.numpy as jnp

_GOLDEN = 0x9E3779B9  # 2**32 / phi — Weyl increment used to decorrelate dims.
_INV_2_24 = float(1.0 / (1 << 24))


def _u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def pcg(x):
    """PCG-RXS-M-XS: advance a 32-bit LCG state and apply output permutation."""
    x = _u32(x)
    x = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((x >> ((x >> jnp.uint32(28)) + jnp.uint32(4))) ^ x) * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def fold(h, v):
    """Mix value ``v`` into hash state ``h`` (boost-style combine + PCG mix)."""
    h = _u32(h)
    v = _u32(v)
    return pcg(h ^ (v + jnp.uint32(_GOLDEN) + (h << jnp.uint32(6)) + (h >> jnp.uint32(2))))


# Stream tags keep distinct consumers of the same (seed, sample, bounce)
# counter space decorrelated.
STREAM_CAMERA = 0
STREAM_BSDF = 1
STREAM_LIGHT = 2


def stream(seed, sample, bounce=0, stream_id: int = STREAM_BSDF):
    """Per-(sample, bounce) hash state; scalar (or broadcastable) uint32."""
    h = pcg(_u32(seed) ^ jnp.uint32(0x6C078965))
    h = fold(h, sample)
    h = fold(h, _u32(bounce) * jnp.uint32(2654435761) + jnp.uint32(stream_id))
    return h


def base(stream_h, pixel_ids):
    """Fold per-pixel counters into a stream hash → per-pixel base ``u32[N]``."""
    return fold(stream_h, pixel_ids)


def bits(base_h, dim: int):
    """Raw 32 random bits for dimension ``dim`` of a base hash."""
    return pcg(_u32(base_h) + jnp.uint32((dim * _GOLDEN) & 0xFFFFFFFF))


def uniform(base_h, dim: int):
    """Uniform float32 in [0, 1) for dimension ``dim``. Shape follows ``base_h``."""
    return (bits(base_h, dim) >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(_INV_2_24)


def uniform2(base_h, dim: int):
    return uniform(base_h, dim), uniform(base_h, dim + 1)


def uniform3(base_h, dim: int):
    return (
        uniform(base_h, dim),
        uniform(base_h, dim + 1),
        uniform(base_h, dim + 2),
    )
