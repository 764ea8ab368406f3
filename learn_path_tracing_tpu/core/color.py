"""Post-processing color pipeline: ACES filmic tonemap + gamma.

Behavior matches /root/reference/taichi_pathtracer/6_diffuse/postprocessing.py:5-29
(byte-identical across stages 6-10): fitted ACES (Stephen Hill's RRT+ODT
approximation) followed by power-law gamma. Implemented as fused elementwise
XLA ops over ``f32[..., 3]`` images.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

# numpy (NOT jnp) on purpose: a module-level jnp.array would initialize the
# default JAX backend at import time, before a CLI's --platform override can
# run. Constants fold into the jitted graphs identically either way.
_ACES_INPUT = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    dtype=np.float32,
)

_ACES_OUTPUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    dtype=np.float32,
)


def aces_tonemap(color: jnp.ndarray) -> jnp.ndarray:
    """ACES filmic tonemap over ``f32[..., 3]`` linear radiance."""
    # HIGHEST: keep the colour matrices out of TF32 on the GPU
    v = jnp.matmul(color, _ACES_INPUT.T, precision=lax.Precision.HIGHEST)
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    v = a / b
    return jnp.maximum(
        jnp.matmul(v, _ACES_OUTPUT.T, precision=lax.Precision.HIGHEST), 0.0)


def gamma_correct(color: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    """Power-law gamma encode. Negative inputs are clamped to 0."""
    return jnp.maximum(color, 0.0) ** (1.0 / gamma)


def post_process(color: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    """The stages-6..10 display transform: ACES then gamma."""
    return gamma_correct(aces_tonemap(color), gamma)
