"""Ray-sphere intersection vs. a straightforward numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest

from learn_path_tracing_tpu.geometry.sphere import intersect_spheres
from learn_path_tracing_tpu.geometry.sphere_f64 import compare_hits

T_MIN = 1e-4


def oracle(ro, rd, centers, radii, transparency, t_min=T_MIN):
    """Direct transcription of the reference scan semantics
    (10_final/world.py:24-33,42-59) in scalar numpy."""
    n = ro.shape[0]
    t_best = np.full(n, np.inf, np.float64)
    idx_best = np.full(n, -1, np.int64)
    for k in range(n):
        for s in range(centers.shape[0]):
            if radii[s] <= 0:
                continue
            oc = ro[k] - centers[s]
            half_b = oc @ rd[k]
            c = oc @ oc - radii[s] ** 2
            disc = half_b * half_b - c
            if disc < 0:
                continue
            sq = np.sqrt(disc)
            t = -half_b - sq
            if t < t_min and transparency[s] > 0:
                t = -half_b + sq
            if t >= t_min and t < t_best[k]:
                t_best[k] = t
                idx_best[k] = s
    return t_best, idx_best


def random_setup(np_rng, n=256, s=20):
    ro = np_rng.normal(size=(n, 3)).astype(np.float32) * 2
    rd = np_rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    centers = np_rng.normal(size=(s, 3)).astype(np.float32) * 3
    radii = np_rng.uniform(0.2, 1.5, size=s).astype(np.float32)
    transparency = (np_rng.uniform(size=s) < 0.3).astype(np.float32)
    return ro, rd, centers, radii, transparency


def _check(t, idx, ro, rd, centers, radii, transparency):
    t_ref, idx_ref = oracle(
        ro.astype(np.float64), rd.astype(np.float64),
        centers.astype(np.float64), radii, transparency,
    )
    t = np.asarray(t)
    idx = np.asarray(idx)
    hit = np.isfinite(t)
    hit_ref = np.isfinite(t_ref)
    # f32 vs f64 can flip borderline discriminants; allow a tiny disagreement rate
    agree = hit == hit_ref
    assert agree.mean() > 0.99
    both = hit & hit_ref & agree
    assert np.allclose(t[both], t_ref[both], rtol=2e-3, atol=2e-3)
    same_obj = idx[both] == idx_ref[both]
    assert same_obj.mean() > 0.99


def test_matches_oracle(np_rng):
    ro, rd, centers, radii, transparency = random_setup(np_rng)
    t, idx = intersect_spheres(*map(jnp.asarray, (ro, rd, centers, radii, transparency)))
    _check(t, idx, ro, rd, centers, radii, transparency)


def test_pallas_kernel_matches_oracle(np_rng):
    """The sphere scan at the size the removed Pallas kernel was tested at
    (more rays and spheres than test_matches_oracle)."""
    ro, rd, centers, radii, transparency = random_setup(np_rng, n=700, s=150)
    t, idx = intersect_spheres(
        *map(jnp.asarray, (ro, rd, centers, radii, transparency)))
    _check(t, idx, ro, rd, centers, radii, transparency)


def test_pallas_matches_xla(np_rng):
    """The sphere scan under jit and under the default and highest matmul
    precisions: the per-pair form has no matrix product, so every
    evaluation agrees to f32 roundoff (grazing hits may amplify that
    slightly through the sqrt)."""
    import jax

    ro, rd, centers, radii, transparency = random_setup(np_rng, n=513, s=130)
    args = list(map(jnp.asarray, (ro, rd, centers, radii, transparency)))
    t0, i0 = intersect_spheres(*args)
    with jax.default_matmul_precision("highest"):
        t1, i1 = jax.jit(intersect_spheres)(*args)
    c = compare_hits(*args, t0, i0, t1, i1)
    assert c["unexplained"] == 0, c
    assert c["hit_miss_flips"] + c["index_mismatches"] <= 2, c


def test_transparent_far_root():
    # Ray starting at the center of a glass sphere must exit through the far wall.
    ro = jnp.zeros((1, 3))
    rd = jnp.array([[0.0, 0.0, -1.0]])
    centers = jnp.zeros((1, 3))
    radii = jnp.array([2.0])
    t, idx = intersect_spheres(ro, rd, centers, radii, jnp.array([1.0]))
    assert np.isclose(float(t[0]), 2.0, atol=1e-5)
    # ...but an opaque sphere from inside yields the same far hit too?
    # No: near root is negative, far root only taken when transparent.
    t2, _ = intersect_spheres(ro, rd, centers, radii, jnp.array([0.0]))
    assert np.isinf(float(t2[0]))


def test_epsilon_skips_self_hit():
    # Ray origin exactly on the surface pointing away: no self-intersection.
    ro = jnp.array([[0.0, 0.0, 1.0]])
    rd = jnp.array([[0.0, 0.0, 1.0]])
    t, _ = intersect_spheres(ro, rd, jnp.zeros((1, 3)), jnp.array([1.0]), jnp.array([0.0]))
    assert np.isinf(float(t[0]))


def test_first_sphere_wins_ties():
    ro = jnp.array([[0.0, 0.0, 5.0]])
    rd = jnp.array([[0.0, 0.0, -1.0]])
    centers = jnp.zeros((2, 3))
    radii = jnp.array([1.0, 1.0])
    t, idx = intersect_spheres(ro, rd, centers, radii, jnp.zeros(2))
    assert int(idx[0]) == 0


def test_padding_spheres_never_hit():
    ro = jnp.array([[0.0, 0.0, 5.0]])
    rd = jnp.array([[0.0, 0.0, -1.0]])
    centers = jnp.zeros((2, 3))
    radii = jnp.array([0.0, 1.0])  # first is padding
    t, idx = intersect_spheres(ro, rd, centers, radii, jnp.zeros(2))
    assert int(idx[0]) == 1 and np.isclose(float(t[0]), 4.0, atol=1e-5)
