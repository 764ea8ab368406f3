"""Wavefront BVH traversal in pure XLA (lax.while_loop).

Wavefront re-design of the reference's per-thread stack machine
(15_module.py:756-779: fixed register stack with ``array_get/array_set``
static unrolls): here the *whole wavefront* steps in lockstep — every live
ray advances its own stack entry each iteration; rays that finish idle until
the last ray is done. States live in ``[N, depth+1]`` arrays; node fetches
are XLA gathers against the flat node table.

Traversal order and hit semantics match the reference exactly (unordered
child push, epsilon-relaxed slab test, strict nearest-t with first-found
tie-break), so BVH results are interchangeable with a brute-force scan.

This module and accel/wide.py are the traversals every platform runs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry.sphere import T_MIN
from ..geometry.triangle import triangle_t
from .bvh import FlatBVH


def stack_read(stack, col):
    """Per-lane stack read: ``stack[i, col[i]]`` as a row-wise gather.

    XLA lowers take_along_axis to a fast vectorized gather; plain
    ``stack[rows, col]`` advanced indexing works too; the WRITE side is a
    select, see stack_write."""
    return jnp.take_along_axis(stack, col[:, None], axis=1)[:, 0]


def stack_write(stack, col, value, mask):
    """Per-lane stack write as a one-hot select: ``stack[i, col[i]] = value[i]``
    where ``mask[i]``. An ``[N, D]`` elementwise select fuses into the
    traversal body, where ``stack.at[rows, col].set(...)`` would be a
    separate XLA scatter per iteration."""
    d = stack.shape[1]
    onehot = jax.lax.broadcasted_iota(jnp.int32, (1, d), 1) == col[:, None]
    return jnp.where(onehot & mask[:, None], value[:, None], stack)


def traverse(bvh: FlatBVH, ro, rd, leaf_test, eps: float = T_MIN,
             t_init=None):
    """Nearest-hit traversal.

    ``leaf_test(prim_idx i32[N], valid bool[N], ro, rd) -> t f32[N]`` must
    return +inf for invalid/missed lanes and respect the epsilon cut.
    ``t_init`` (optional f32[N]) seeds the best-t for cross-structure
    pruning (e.g. a previous BVH's results); pruned-only hits keep prim=-1.

    Returns ``(t f32[N] (+inf miss), prim i32[N] (-1 miss))``.
    """
    n = ro.shape[0]
    depth_cap = bvh.max_depth + 2
    max_leaf = bvh.max_leaf
    n_prim = bvh.prim.shape[0]
    n_nodes = bvh.left.shape[0]
    # Hard iteration backstop: a lockstep traversal visits at most every
    # node once per lane (2*nodes stack events); without a bound, any
    # pathological input would spin forever.
    max_iters = 4 * n_nodes + 64

    def cond(state):
        sp, it = state[1], state[4]
        return jnp.any(sp >= 0) & (it < max_iters)

    def body(state):
        stack, sp, t_best, prim_best, it = state
        active = sp >= 0
        slot = jnp.clip(sp, 0, depth_cap - 1)
        cur = stack_read(stack, slot)

        low = jnp.take(bvh.low, cur, axis=0)
        high = jnp.take(bvh.high, cur, axis=0)
        inv = 1.0 / rd
        ti_ = (low - ro) * inv
        to_ = (high - ro) * inv
        t1 = jnp.min(jnp.maximum(ti_, to_), axis=-1)
        t0 = jnp.max(jnp.minimum(ti_, to_), axis=-1)
        # slab test (15_module.py:851-861) + t-pruning: skip boxes whose
        # entry distance can no longer beat the current best hit
        hitbox = (t1 > t0 - eps) & (t1 > 0.0) & (t0 < t_best + eps) & active

        data = jnp.take(bvh.data, cur, axis=0)
        is_leaf = (data >= 0) & hitbox

        # Leaf scan: up to max_leaf primitive tests, statically unrolled.
        leaf_id = jnp.maximum(data, 0)
        start = jnp.take(bvh.cut, leaf_id, axis=0)
        count = jnp.take(bvh.cut, leaf_id + 1, axis=0) - start
        for k in range(max_leaf):
            pidx = jnp.take(bvh.prim, jnp.clip(start + k, 0, max(n_prim - 1, 0)),
                            axis=0)
            valid = is_leaf & (k < count)
            t = leaf_test(pidx, valid, ro, rd)
            better = valid & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            prim_best = jnp.where(better, pidx, prim_best)

        # Stack update (mirrors 15_module.py:645-655): on an inner-node hit,
        # overwrite the current slot with `left` and push `right`; otherwise pop.
        left = jnp.take(bvh.left, cur, axis=0)
        right = jnp.take(bvh.right, cur, axis=0)
        push = hitbox & ~is_leaf
        stack = stack_write(stack, slot, left, push)
        new_sp = jnp.where(push, sp + 1, jnp.where(active, sp - 1, sp))
        new_slot = jnp.clip(new_sp, 0, depth_cap - 1)
        stack = stack_write(stack, new_slot, right, push)
        return stack, new_sp, t_best, prim_best, it + 1

    stack0 = jnp.zeros((n, depth_cap), jnp.int32)
    sp0 = jnp.zeros((n,), jnp.int32)
    t0 = (jnp.full((n,), jnp.inf, jnp.float32) if t_init is None
          else jnp.asarray(t_init))
    p0 = jnp.full((n,), -1, jnp.int32)
    _, _, t_best, prim_best, _ = jax.lax.while_loop(
        cond, body, (stack0, sp0, t0, p0, jnp.int32(0)))
    return t_best, prim_best


def make_sphere_leaf_test(centers, radii, transparency, eps: float = T_MIN):
    """Leaf test over a sphere table (same quadratic semantics as
    geometry.sphere.intersect_spheres, one primitive per lane)."""

    def leaf_test(pidx, valid, ro, rd):
        c = jnp.take(centers, pidx, axis=0)
        r = jnp.take(radii, pidx, axis=0)
        tr = jnp.take(transparency, pidx, axis=0)
        oc = ro - c
        half_b = jnp.sum(oc * rd, axis=-1)
        cterm = jnp.sum(oc * oc, axis=-1) - r * r
        disc = half_b * half_b - cterm
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t_near = -half_b - sq
        t_far = -half_b + sq
        t = jnp.where((t_near < eps) & (tr > 0.0), t_far, t_near)
        ok = valid & (disc >= 0.0) & (t > eps)
        return jnp.where(ok, t, jnp.inf)

    return leaf_test


def make_triangle_leaf_test(v0, v1, v2, eps: float = T_MIN):
    """Leaf test over a triangle vertex-position table ``v0/v1/v2: f32[T,3]``."""

    def leaf_test(pidx, valid, ro, rd):
        p1 = jnp.take(v0, pidx, axis=0)
        p2 = jnp.take(v1, pidx, axis=0)
        p3 = jnp.take(v2, pidx, axis=0)
        t = triangle_t(p1, p2, p3, ro, rd, eps=eps)
        return jnp.where(valid, t, jnp.inf)

    return leaf_test
