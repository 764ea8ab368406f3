"""Numerical-safety checks (the race-detection/sanitizer slot of SURVEY §5).

The reference relies on Taichi atomics and one in-kernel assert
(legacy/test.py:13). These wavefronts use no atomics (each pixel is owned by
one lane), so the failure mode to guard is NaN/Inf contamination instead:

- ``validate_image``: host-side post-render check (free; use in stages);
- ``checked_render``: jax.experimental.checkify wrapper that errors inside
  jit when radiance goes non-finite (debug tool, ~2x slower).
"""

from __future__ import annotations

import numpy as np


def validate_image(img, label: str = "image") -> None:
    a = np.asarray(img)
    bad = ~np.isfinite(a)
    if bad.any():
        frac = bad.mean()
        idx = np.argwhere(bad)[0]
        raise FloatingPointError(
            f"{label}: {frac:.2%} non-finite values (first at {idx.tolist()})")
    if (a < 0).any():
        raise FloatingPointError(f"{label}: negative radiance present")


def device_smoke_test() -> bool:
    """Equivalent of the reference's legacy/test.py device check: run a tiny
    jitted vector-math kernel on the default backend and assert the result."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def kernel():
        a = jnp.array([1.0, 2.0, 2.0])
        n = jnp.sqrt(jnp.sum(a * a))
        return n

    n = float(kernel())
    assert n > 3.0 - 1e-3, f"device vector math broken: |a|={n}"
    return True


def checked_trace(fn, *args, **kwargs):
    """Run ``fn`` under checkify with float checks enabled; raises on the
    first NaN/Inf produced inside the jitted computation."""
    import jax
    from jax.experimental import checkify

    checked = checkify.checkify(fn, errors=checkify.float_checks)
    err, out = jax.jit(lambda *a: checked(*a))(*args, **kwargs)
    err.throw()
    return out
