"""Float64 NumPy oracle for the ray-sphere nearest hit, with the error that
an f32 evaluation of the same per-pair quadratic may carry.

Two correct f32 evaluations of ``geometry.sphere.intersect_spheres`` (two
fusions, two compilers) differ only in FMA contraction and
summation order, yet that can move ``t`` far more than one ulp where the
quadratic is ill-conditioned: a secondary ray that starts on a sphere's
surface (``t_near ~ c0 / 2 half_b`` is all cancellation), a near-tangent
ray (``sqrt`` of a tiny discriminant), or the 10,000-radius ground sphere
(``|oc|^2 - r^2`` of two ~1e8 terms). ``compare_hits`` therefore holds two
results to ``1e-5`` relative in ``t`` wherever the problem is
well-conditioned, to the f32 forward-error bound where it is not, and
accepts a different answer (hit vs miss, another sphere, the far root)
only where the f64 evaluation shows that an f32 rounding can decide it.
"""

from __future__ import annotations

import numpy as np

EPS32 = float(np.finfo(np.float32).eps)
# safety factor on the first-order error estimate (a handful of roundings
# per term)
_K = 8.0


def pair_terms(ro, rd, center, radius, round_oc=True):
    """f64 ``(half_b, c0, disc, scale)`` of rays ``[M,3]`` against one sphere
    per ray (``center [M,3]``, ``radius [M]``); ``scale`` bounds the
    magnitude of the terms that cancel in ``disc``. ``round_oc=False``
    leaves out the rounding of ``oc = ro - c``, which two f32
    implementations of the per-pair form share exactly."""
    oc = np.asarray(ro, np.float64) - np.asarray(center, np.float64)
    d = np.asarray(rd, np.float64)
    r2 = np.asarray(radius, np.float64) ** 2
    hb = -np.sum(oc * d, axis=-1)
    occ = np.sum(oc * oc, axis=-1)
    c0 = occ - r2
    scale = hb * hb + occ + r2
    if round_oc:
        # oc itself is rounded relative to max(|ro|, |c|), which is what
        # makes the ground sphere's c0 uncertain by ~eps * 1e8 against f64
        scale = scale + np.maximum(
            np.sum(np.asarray(ro, np.float64) ** 2, -1),
            np.sum(np.asarray(center, np.float64) ** 2, -1))
    return hb, c0, hb * hb - c0, scale


def pair_hit(ro, rd, center, radius, transparent, t_min, round_oc=True):
    """f64 ``(t, err_t, ambiguous)`` of each ray against its own sphere:
    ``t`` by the reference's rules (+inf on a miss), ``err_t`` the f32
    forward-error bound on ``t``, and ``ambiguous`` where an f32 rounding
    can flip the outcome (tangent ray, a root within ``err_t`` of
    ``t_min``)."""
    hb, c0, disc, scale = pair_terms(ro, rd, center, radius, round_oc)
    err_disc = _K * EPS32 * scale
    sq = np.sqrt(np.maximum(disc, 0.0))
    err_t = _K * EPS32 * (np.abs(hb) + np.sqrt(scale)) + err_disc / (
        2.0 * np.sqrt(np.maximum(np.abs(disc), err_disc)))
    t_near, t_far = hb - sq, hb + sq
    transparent = np.asarray(transparent, bool)
    use_far = (t_near < t_min) & transparent
    t = np.where(use_far, t_far, t_near)
    valid = (disc >= 0) & (t >= t_min) & (np.asarray(radius) > 0)
    t = np.where(valid, t, np.inf)
    ambiguous = ((np.abs(disc) <= err_disc)
                 | (np.abs(t_near - t_min) <= err_t)
                 | (transparent & (np.abs(t_far - t_min) <= err_t)))
    return t, err_t, ambiguous


def nearest_hit(ro, rd, centers, radii, transparency, t_min=1e-4,
                chunk=4096):
    """Brute-force f64 nearest hit: ``(t [N], idx [N])``, first sphere wins
    ties, ``t = +inf`` and ``idx = 0`` on a miss."""
    ro = np.asarray(ro, np.float64)
    rd = np.asarray(rd, np.float64)
    n, s = ro.shape[0], len(radii)
    t_out = np.full(n, np.inf)
    i_out = np.zeros(n, np.int32)
    cen = np.broadcast_to(np.asarray(centers, np.float64)[None], (chunk, s, 3))
    rad = np.broadcast_to(np.asarray(radii, np.float64)[None], (chunk, s))
    tra = np.broadcast_to(np.asarray(transparency)[None] > 0, (chunk, s))
    for a in range(0, n, chunk):
        m = min(chunk, n - a)
        t, _, _ = pair_hit(np.repeat(ro[a:a + m, None], s, 1),
                           np.repeat(rd[a:a + m, None], s, 1),
                           cen[:m], rad[:m], tra[:m], t_min)
        idx = np.argmin(t, axis=1)
        t_out[a:a + m] = t[np.arange(m), idx]
        i_out[a:a + m] = np.where(np.isfinite(t_out[a:a + m]), idx, 0)
    return t_out, i_out


def secondary_rays(ro, rd, t, idx, centers, radii, n, rng):
    """``n`` diffuse secondary rays ``(ro [n,3], rd [n,3])`` (f32) leaving
    hit points of the rays ``(ro, rd)`` with hits ``(t, idx)``: origins at
    seeded hit points, directions cosine-distributed about the outward
    normal, as the renderer's Lambertian bounce draws them."""
    hit = np.flatnonzero(np.isfinite(t))
    k = hit[rng.integers(0, len(hit), n)]
    p = ro[k] + t[k, None] * rd[k]
    normal = (p - centers[idx[k]]) / radii[idx[k], None]
    normal *= np.where(np.sum(normal * rd[k], -1) > 0, -1.0, 1.0)[:, None]
    u = rng.normal(size=(n, 3))
    d = normal + u / np.linalg.norm(u, axis=-1, keepdims=True)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p.astype(np.float32), d.astype(np.float32)


def compare_hits(ro, rd, centers, radii, transparency, t_a, i_a, t_b, i_b,
                 t_min=1e-4, rtol=1e-5, round_oc=False):
    """Compare two nearest-hit results ``(t, idx)`` of the same rays.

    Returns a dict of counts. ``unexplained`` counts the rays on which the
    two disagree by more than ``rtol`` relative (or the f32 error bound,
    where that is larger) without an f32 rounding that can account for
    it; a correct pair of implementations has none. ``over_rtol`` counts
    the rays whose ``t`` differ by more than ``rtol`` relative at all.
    ``round_oc``: True where ``b`` is the f64 oracle (see ``pair_terms``)."""
    ro = np.asarray(ro, np.float32)
    rd = np.asarray(rd, np.float32)
    cen = np.asarray(centers, np.float64)
    rad = np.asarray(radii, np.float64)
    tra = np.asarray(transparency) > 0
    t_a, t_b = np.asarray(t_a, np.float64), np.asarray(t_b, np.float64)
    i_a, i_b = np.asarray(i_a), np.asarray(i_b)
    hit_a, hit_b = np.isfinite(t_a), np.isfinite(t_b)

    both = hit_a & hit_b
    with np.errstate(invalid="ignore"):   # inf - inf on misses
        dt = np.abs(np.where(both, t_a - t_b, 0.0))
    rel = np.where(both, dt / np.where(both, np.abs(t_b), 1.0), 0.0)
    over = both & (rel > rtol)

    # rays to explain: over rtol, hit/miss flips, or another sphere
    k = np.flatnonzero(over | (hit_a != hit_b) | (both & (i_a != i_b)))
    _, ea, amb_a = pair_hit(ro[k], rd[k], cen[i_a[k]], rad[i_a[k]],
                            tra[i_a[k]], t_min, round_oc)
    _, eb, amb_b = pair_hit(ro[k], rd[k], cen[i_b[k]], rad[i_b[k]],
                            tra[i_b[k]], t_min, round_oc)
    tol = np.maximum(rtol * np.abs(t_b[k]), ea + eb)
    # the same answer, or a tie between two spheres, within the f32 error
    # of each side
    close = both[k] & (dt[k] <= tol)
    # an outcome that an f32 rounding can decide: a hit that the other
    # side missed, another sphere, or the other root of the same one
    rounding = (hit_a[k] & amb_a) | (hit_b[k] & amb_b)
    unexplained = ~(close | rounding)
    return {
        "rays": int(t_a.shape[0]),
        "hits": int(hit_b.sum()),
        "max_rel_dt": float(rel.max()) if rel.size else 0.0,
        "over_rtol": int(over.sum()),
        "hit_miss_flips": int(np.sum(hit_a != hit_b)),
        "index_mismatches": int(np.sum(both & (i_a != i_b))),
        "explained_by_rounding": int(np.sum(~close & rounding)),
        "unexplained": int(unexplained.sum()),
    }
