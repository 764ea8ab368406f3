"""Persistent-wavefront integrator with path regeneration.

The reference's wavefront relies on Taichi's sparse bitmasked pools to skip
dead rays (15_module.py:56-57,1032-1034). In a dense wavefront, masked
lanes still cost their share of every pass, so a fixed bounce loop wastes
~(limit / avg_bounces)x of the intersection work. This integrator keeps
every lane busy instead:

- the render is a list of ``N*spp`` work items; item ``w`` is
  (pixel = w // spp, sample = w % spp); lane ``i`` processes items
  ``i, i+N, i+2N, ...`` — successive items on a lane land on *different*
  pixels, so per-lane total path length concentrates around the mean and
  the straggler tail stays small (unlike binding a lane to one pixel,
  where a single glassy pixel serializes spp * max_bounce passes);
- when a lane's path ends (escape or bounce budget), it immediately starts
  its next work item's primary ray;
- escaped radiance accumulation exploits the work-item algebra: with
  ``witem = lane + k*n`` and ``spp | n``, the target pixel decomposes as
  ``pixel = group + k*(n/spp)`` where ``group = lane // spp`` is *static*
  per lane and only ``k`` (the per-lane item counter, < spp) is dynamic.
  The per-pixel scatter-add therefore becomes a batched one-hot matmul
  over the tiny spp axis into an ``[n/spp, spp, 3]`` accumulator, plus a
  single transpose at the end. When ``spp`` does not divide ``n`` the
  scatter fallback is used.

RNG streams are counter-based on absolute (pixel, sample, bounce), so this
computes exactly the same per-sample radiance values as
integrator.wavefront.render — only the per-pixel summation order differs
(f32 reassociation ~1 ulp). Traced-segment counts match exactly
(tests/test_persistent.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..bsdf.bsdf import SCATTERERS
from ..camera.camera import CameraParams, generate_rays_for_pixels
from ..core import rng
from ..core.pytree import tree_where
from .wavefront import _scene_fns

# Smallest auto-policy pool (lanes): below it per-pass fixed costs dominate.
POOL_FLOOR = 57600

# items_per above which the accumulate switches from the flat one-hot to
# the sliding window (see ``accumulate``): the flat one-hot's per-pass
# traffic grows with items_per.
_ACC_SPLIT_MIN_ITEMS = 1280

# Sliding accumulation-window width (see ``accumulate_w`` in
# _persistent_core): the spread of per-lane item counters stays well under
# +-200 on these workloads (item lists concentrate by CLT), so 1024 leaves
# a wide margin and parking ~never fires.
ACC_WINDOW = 1024


@partial(jax.jit, static_argnames=("resolution", "spp", "limit", "bsdf",
                                   "camera_model", "scene", "hit_backend",
                                   "pool_mult", "pool_div",
                                   "drain_ratio", "drain_floor",
                                   "drain_unroll", "acc_split", "stats"))
def render_persistent(world_data, cam: CameraParams, resolution, spp: int,
                      limit: int = 32, seed=0, bsdf: str = "modern",
                      camera_model: str = "thinlens", scene: str = "spheres",
                      hit_backend: str = "auto",
                      pool_mult: int = 0, pool_div: int = 0,
                      drain_ratio: int = 8, drain_floor: int = 0,
                      drain_unroll: int = 0, acc_split: int = 0,
                      stats: bool = False):
    """Returns (image f32[W,H,3], segments f32). Same sample values as
    wavefront.render; per-pixel sum order differs (~1 ulp)."""
    w, h = resolution
    n = w * h
    out = _persistent_core(
        world_data, cam, resolution, n, 0, 0, spp, limit, seed, bsdf,
        camera_model, scene, hit_backend, pool_mult, pool_div, drain_ratio,
        drain_floor, drain_unroll, acc_split, stats)
    if stats:
        acc_flat, segments, st = out
        return (acc_flat / spp).reshape(w, h, 3), segments, st
    acc_flat, segments = out
    return (acc_flat / spp).reshape(w, h, 3), segments


def _persistent_core(world_data, cam: CameraParams, resolution, n: int,
                     pixel_base, sample_base, spp: int, limit: int, seed,
                     bsdf: str, camera_model: str, scene: str,
                     hit_backend: str, pool_mult: int, pool_div: int,
                     drain_ratio: int, drain_floor: int = 0,
                     drain_unroll: int = 0, acc_split: int = 0,
                     stats: bool = False):
    """Persistent render over a pixel range and sample range.

    Traces samples ``[sample_base, sample_base + spp)`` of pixels
    ``[pixel_base, pixel_base + n)`` of the full ``resolution`` image and
    returns ``(acc f32[n, 3] radiance sums, segments f32)`` (plus a stats
    dict when requested). ``pixel_base``/``sample_base`` may be traced
    scalars — this is the shard body for parallel.mesh's tile/spp-sharded
    persistent path: the item schedule, drain cascade and accumulation are
    all local to the range, so a shard needs no cross-chip traffic until
    the final image gather. RNG streams are keyed on absolute
    (pixel, sample), so per-sample radiance is reshard-invariant.
    """
    total = n * spp
    pixel_base = jnp.uint32(pixel_base)
    sample_base = jnp.uint32(sample_base)
    scatter = SCATTERERS[bsdf]
    hit_fn, background_fn = _scene_fns(scene)
    matmul_acc = (n % spp == 0)

    # Pool sizing. The work-item algebra holds for ANY pool size with
    # spp | pool and pool | n*spp: item k of lane L is
    # pixel = L//spp + k*G (G = pool//spp), sample = L % spp,
    # k < items_per = n*spp/pool.
    #
    # pool > n (pool_mult) shortens per-lane item lists (occupancy decay
    # sets in sooner), widens drain levels and grows the sort. pool < n
    # (pool_div) goes the other way: longer item lists = sharper lane-work
    # concentration = higher occupancy, at the price of more passes
    # (per-pass fixed overhead). Default: auto policy below.
    if pool_mult and pool_div:
        raise ValueError("pool_mult and pool_div are mutually exclusive")
    if not matmul_acc:
        if pool_mult or pool_div:
            raise ValueError(
                f"pool_mult/pool_div need spp | n (n={n}, spp={spp})")
        pool = n
    elif pool_mult:
        if spp % pool_mult != 0:
            # items_per = spp // q truncates; a non-divisor q would silently
            # drop the last spp % q samples of every pixel (image still
            # divided by the full spp → darkened render).
            raise ValueError(
                f"pool_mult={pool_mult} must divide spp={spp} "
                f"(each lane runs spp/pool_mult work items)")
        pool = pool_mult * n
    elif pool_div:
        # Fractional pool: fewer lanes, each running ~pool_div*spp work
        # items. Longer per-lane item lists concentrate total lane work
        # around the mean (CLT), so end-of-schedule occupancy decay shrinks
        # as 1/sqrt(items_per). The item algebra needs only
        # spp | pool (items_per is a ceiling; overshoot items are masked).
        pool = -(-(n // pool_div) // spp) * spp
        if pool < spp:
            raise ValueError(
                f"pool_div={pool_div} leaves a pool below spp={spp}")
    else:
        # Auto policy: occupancy improves with item-list length until
        # per-pass fixed costs dominate, so halve while staying >=
        # POOL_FLOOR, then round up to an spp multiple (works for ANY n,
        # e.g. the 3000x2000 flagship render). Legacy mesh scenes carry a
        # larger fixed cost per pass (sorts + atlas gathers), so they keep
        # the full-width pool.
        pool = n
        if matmul_acc and scene != "legacy":
            while pool // 2 >= POOL_FLOOR:
                pool //= 2
            pool = -(-pool // spp) * spp
            # Align the pool to whole 1024-lane blocks when spp allows
            # (no padded dead lanes in the intersect pass). Floor to the
            # largest block-aligned spp-multiple >= POOL_FLOOR/2.
            import math

            step = math.lcm(1024, spp)
            if step <= pool and (pool // step) * step * 2 >= POOL_FLOOR:
                pool = (pool // step) * step
    # items_per is a CEILING: pool need not divide n*spp — item slots whose
    # pixel lands past n are masked invalid in item_of and never traced.
    items_per = -(-(n * spp) // pool) if matmul_acc else spp
    lanes = jnp.arange(pool, dtype=jnp.uint32)
    groups = pool // spp if matmul_acc else 0

    sample_const = (lanes % jnp.uint32(spp)) if matmul_acc else None
    group_const = (lanes // jnp.uint32(spp)) if matmul_acc else None

    def item_of(k):
        """k-th work item of each lane → (valid, pixel u32[P], sample u32[P])."""
        if matmul_acc:
            pixel = group_const + k * jnp.uint32(groups)
            valid = (k < jnp.uint32(items_per)) & (pixel < jnp.uint32(n))
            pixel = jnp.minimum(pixel, jnp.uint32(n - 1))
            return valid, pixel, sample_const
        witem = lanes + k * jnp.uint32(pool)
        valid = witem < total
        pixel = jnp.minimum(witem // jnp.uint32(spp), jnp.uint32(n - 1))
        sample = witem % jnp.uint32(spp)
        return valid, pixel, sample

    def primary(pixel, sample):
        # item-algebra pixels/samples are range-local; RNG + camera take
        # absolute ids so shards compute identical per-sample radiance
        return generate_rays_for_pixels(cam, resolution, pixel + pixel_base,
                                        seed, sample + sample_base,
                                        model=camera_model)

    valid0, pix0, samp0 = item_of(jnp.uint32(0))
    rays0 = primary(pix0, samp0)
    rays0 = type(rays0)(ro=rays0.ro, rd=rays0.rd, throughput=rays0.throughput,
                        alive=valid0)
    live0 = jnp.sum(valid0.astype(jnp.float32))

    # The live-lane count is CARRIED in the loop state (computed inside the
    # body where it fuses with the alive-mask math) so every while cond is a
    # scalar compare instead of a fresh full-array reduction.
    def cond(state):
        return state[-1] > 0.0

    # Accumulation-cost policy. The flat one-hot's per-pass traffic grows
    # with items_per (its operand is [g, spp, items]), so past
    # _ACC_SPLIT_MIN_ITEMS a SLIDING-WINDOW one-hot takes over. Lane item
    # counters k all start at 0 and advance by at most 1 per pass, so the
    # live k-range is tightly concentrated; deposits one-hot against a
    # WIN-wide window ``wacc[groups, WIN, 3]`` over ``k - wbase`` (cost independent of
    # items_per) and half-windows flush into the big accumulator by
    # dynamic-slice adds (no one-hot). A lane whose NEXT item would start
    # at k >= wbase + WIN parks (no fresh ray) until the window slides —
    # so every deposit provably lands in-window and results stay exactly
    # the flat path's term set per (g, k) cell (~1 ulp add-order freedom).
    #
    # ``acc_split``: 0 = auto (flat below _ACC_SPLIT_MIN_ITEMS, windowed
    # above), 1 = force flat, -1 = drop contributions (profiling only),
    # -2 = force windowed (tests), >1 = the two-level factorized one-hot
    # (k = q*P + p), kept as an ablation.
    _acc_P = 1
    windowed = (matmul_acc and acc_split in (0, -2)
                and (acc_split == -2
                     or items_per > _ACC_SPLIT_MIN_ITEMS))
    if matmul_acc and acc_split > 1:
        _acc_P = acc_split
        items_per = -(-items_per // _acc_P) * _acc_P
    _WIN = ACC_WINDOW if windowed else 0

    def accumulate(acc, k, pixel, contrib):
        """Add per-lane contributions to the accumulator.

        matmul path: ``acc`` is ``f32[groups, items_per, 3]`` indexed by
        (lane//spp, k); one-hot(s) over k run as batched matrix
        contractions — no scatter.
        """
        if not matmul_acc:
            return acc.at[pixel].add(contrib)
        if acc_split == -1:      # profiling only: drop contributions
            return acc + 0.0 * jnp.sum(contrib)
        k_g = k.reshape(groups, spp)
        c_g = contrib.reshape(groups, spp, 3)
        if _acc_P > 1:
            # Two-level exact path: both one-hots are 0/1 (exact bf16) and
            # the f32 contribution splits exactly into 3 bf16 parts
            # (24 = 3x8 mantissa bits), so ONE default-precision pass
            # with f32 accumulation reproduces the flat path's term set.
            q_w = items_per // _acc_P
            q_g = k_g // jnp.uint32(_acc_P)
            p_g = k_g % jnp.uint32(_acc_P)
            hi = c_g.astype(jnp.bfloat16)
            r1 = c_g - hi.astype(jnp.float32)
            lo = r1.astype(jnp.bfloat16)
            lo2 = (r1 - lo.astype(jnp.float32)).astype(jnp.bfloat16)
            c9 = jnp.concatenate([hi, lo, lo2], axis=-1)   # bf16 [g, spp, 9]
            oh_p = (p_g[:, :, None]
                    == jnp.arange(_acc_P, dtype=jnp.uint32)
                    ).astype(jnp.bfloat16)                 # [g, spp, P]
            tmp = (oh_p[..., None] * c9[:, :, None, :]
                   ).reshape(groups, spp, _acc_P * 9)      # [g, spp, P*9]
            oh_q = (q_g[:, :, None]
                    == jnp.arange(q_w, dtype=jnp.uint32)
                    ).astype(jnp.bfloat16)                 # [g, spp, q_w]
            d = jax.lax.dot_general(
                oh_q, tmp, (((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)        # [g, q_w, P*9]
            d = d.reshape(groups, items_per, 9)
            return acc + (d[..., 0:3] + d[..., 3:6] + d[..., 6:9])
        # Exact bf16-split accumulation at default precision. The one-hot
        # operand is exactly representable in bf16 (entries are 0/1), and
        # an f32 contribution splits EXACTLY into 3 non-overlapping bf16
        # parts (24 = 3x8 mantissa bits), so every bf16 x bf16 product is
        # exact and the tensor cores accumulate in f32 — exact in any
        # tensor-core mode, with no precision flag needed. Same term set
        # per (g, item) cell — only f32 add order differs (~1 ulp, the
        # integrator's documented freedom).
        onehot = (k_g[:, :, None] == jnp.arange(items_per, dtype=jnp.uint32)
                  ).astype(jnp.bfloat16)
        hi = c_g.astype(jnp.bfloat16)
        r1 = c_g - hi.astype(jnp.float32)
        lo = r1.astype(jnp.bfloat16)
        lo2 = (r1 - lo.astype(jnp.float32)).astype(jnp.bfloat16)
        c9 = jnp.concatenate([hi, lo, lo2], axis=-1)     # bf16 [g, spp, 9]
        d = jax.lax.dot_general(
            onehot, c9, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)          # [g, items, 9]
        return acc + (d[..., 0:3] + d[..., 3:6] + d[..., 6:9])

    def step(rays, k, bounce, pixel, sample, item_fn, parked=None,
             window_hi=None):
        """One bounce pass; shared by the full-width and drain loops.
        Returns (rays', k', bounce', contrib, live_before, live_after,
        parked'). ``parked``/``window_hi`` drive the windowed-accumulation
        schedule: a parked lane holds an already-advanced item counter but
        no ray; it (re)starts its item only once ``next_k < window_hi``,
        guaranteeing every deposit lands inside the accumulation window."""
        hits = hit_fn(world_data, rays, hit_backend)
        live = jnp.sum(rays.alive.astype(jnp.float32))

        escaped = rays.alive & ~hits.hit
        contrib = jnp.where(
            escaped[:, None],
            background_fn(world_data, rays.rd, escaped) * rays.throughput, 0.0)

        base = rng.base(rng.stream(seed, sample + sample_base, bounce,
                                   rng.STREAM_BSDF),
                        pixel + pixel_base)
        scattered = scatter(rays, hits, base)
        survived = rays.alive & hits.hit & (bounce + 1 < limit)

        # lanes whose path ended advance to their next work item; parked
        # lanes already advanced and only await a window slide
        ended = rays.alive & ~survived
        if parked is None:
            next_k = k + ended.astype(jnp.uint32)
            candidates = ended
        else:
            next_k = jnp.where(parked, k, k + ended.astype(jnp.uint32))
            candidates = ended | parked
        nvalid, npix, nsamp = item_fn(next_k)
        ok = nvalid
        if window_hi is not None:
            ok = nvalid & (next_k < window_hi)
        need_regen = candidates & ok
        parked_out = (candidates & nvalid & ~ok if window_hi is not None
                      else None)
        fresh = primary(npix, nsamp)

        rays = tree_where(survived, scattered,
                          tree_where(need_regen, fresh, rays))
        alive = survived | need_regen
        rays = type(rays)(ro=rays.ro, rd=rays.rd, throughput=rays.throughput,
                          alive=alive)
        bounce = jnp.where(survived, bounce + 1, jnp.uint32(0))
        live_after = jnp.sum(alive.astype(jnp.float32))
        return rays, next_k, bounce, contrib, live, live_after, parked_out

    def body(state):
        rays, k, bounce, acc, segments, passes, _ = state
        _, pixel, sample = item_of(k)
        rays, next_k, bounce, contrib, live, live_after, _pk = step(
            rays, k, bounce, pixel, sample, item_of)
        acc = accumulate(acc, k, pixel, contrib)
        return (rays, next_k, bounce, acc, segments + live, passes + 1.0,
                live_after)

    halfw = _WIN // 2
    if windowed:
        karange_w = jnp.arange(_WIN, dtype=jnp.uint32)

        def accumulate_w(wacc, kw, contrib):
            """Window deposit: the flat bf16-split one-hot over the
            WIN-wide window — same exact term set (kw is in [0, WIN) for
            every lane whose contrib can be nonzero; see step's parking)."""
            k_g = kw.reshape(groups, spp)
            c_g = contrib.reshape(groups, spp, 3)
            onehot = (k_g[:, :, None] == karange_w).astype(jnp.bfloat16)
            hi = c_g.astype(jnp.bfloat16)
            r1 = c_g - hi.astype(jnp.float32)
            lo = r1.astype(jnp.bfloat16)
            lo2 = (r1 - lo.astype(jnp.float32)).astype(jnp.bfloat16)
            c9 = jnp.concatenate([hi, lo, lo2], axis=-1)
            d = jax.lax.dot_general(
                onehot, c9, (((1,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32)
            return wacc + (d[..., 0:3] + d[..., 3:6] + d[..., 6:9])

        def flush_half(op):
            acc, wacc, wbase = op
            i0 = wbase.astype(jnp.int32)
            cur = jax.lax.dynamic_slice(acc, (jnp.int32(0), i0, jnp.int32(0)),
                                        (groups, halfw, 3))
            acc = jax.lax.dynamic_update_slice(
                acc, cur + wacc[:, :halfw], (jnp.int32(0), i0, jnp.int32(0)))
            wacc = jnp.concatenate(
                [wacc[:, halfw:],
                 jnp.zeros((groups, halfw, 3), jnp.float32)], axis=1)
            return acc, wacc, wbase + jnp.uint32(halfw)

        def body_w(state):
            (rays, k, bounce, acc, wacc, wbase, parked, segments, passes,
             _) = state
            # slide the window once the slowest unfinished lane clears the
            # lower half (the flush is a dynamic-slice add — no one-hot)
            unfinished = rays.alive | parked
            minval = jnp.min(jnp.where(unfinished, k,
                                       jnp.uint32(0xFFFFFFFF)))
            slide = ((minval != jnp.uint32(0xFFFFFFFF))
                     & (minval >= wbase + jnp.uint32(halfw)))
            acc, wacc, wbase = jax.lax.cond(
                slide, flush_half, lambda op: op, (acc, wacc, wbase))

            _, pixel, sample = item_of(k)
            rays, next_k, bounce, contrib, live, live_after, parked = step(
                rays, k, bounce, pixel, sample, item_of, parked=parked,
                window_hi=wbase + jnp.uint32(_WIN))
            wacc = accumulate_w(wacc, k - wbase, contrib)
            live_sig = live_after + jnp.sum(parked.astype(jnp.float32))
            return (rays, next_k, bounce, acc, wacc, wbase, parked,
                    segments + live, passes + 1.0, live_sig)

    if windowed:
        # extra WIN rows so the final full-window flush at wbase <=
        # items_per - 1 never clamps; the padded rows map past n and are
        # sliced off after the transpose
        acc0 = jnp.zeros((groups, items_per + _WIN, 3), jnp.float32)
        state0 = (
            rays0,
            jnp.zeros((pool,), jnp.uint32),
            jnp.zeros((pool,), jnp.uint32),
            acc0,
            jnp.zeros((groups, _WIN, 3), jnp.float32),   # window acc
            jnp.uint32(0),                               # window base
            jnp.zeros((pool,), bool),                    # parked lanes
            jnp.float32(0.0),
            jnp.float32(0.0),   # pass counter (telemetry)
            live0,              # carried live count (cond reads a scalar)
        )
    else:
        acc0 = (jnp.zeros((groups, items_per, 3), jnp.float32) if matmul_acc
                else jnp.zeros((n, 3), jnp.float32))
        state0 = (
            rays0,
            jnp.zeros((pool,), jnp.uint32),
            jnp.zeros((pool,), jnp.uint32),
            acc0,
            jnp.float32(0.0),
            jnp.float32(0.0),   # pass counter (telemetry)
            live0,              # carried live count (cond reads a scalar)
        )

    # Drain compaction: the static item schedule leaves a long straggler
    # tail — the last few % of work can take most of the passes, each
    # paying full-wavefront intersect/shade cost. Cascade: whenever the
    # live-lane count falls below the next (8x narrower) width, argsort-
    # compact the surviving lane state into that width, so tail passes cost
    # 1/8, 1/64, ... of a full pass. Contributions in drain levels
    # scatter-add into a flat pixel accumulator (cheap at narrow widths).
    def _round256(v):
        return -(-v // 256) * 256

    # drain_floor: narrowest level the cascade may reach (default 256).
    if drain_floor <= 0:
        drain_floor = 256
    _ratio = drain_ratio
    levels = []
    lw = _round256(pool // _ratio)
    while (matmul_acc and lw >= drain_floor
           and lw < (levels[-1] if levels else pool)):
        levels.append(lw)
        lw = _round256(lw // _ratio)

    if levels:
        def cond1(state):
            return state[-1] > jnp.float32(levels[0])
    else:
        cond1 = cond
    if windowed:
        (rays, k, bounce, acc, wacc, wbase, parked, segments, passes_full,
         live_now) = jax.lax.while_loop(cond1, body_w, state0)
        # flush the full window, then wake every still-parked lane: the
        # drain levels deposit by scatter-add into the flat pixel
        # accumulator, so they have no window constraint
        i0 = wbase.astype(jnp.int32)
        cur = jax.lax.dynamic_slice(acc, (jnp.int32(0), i0, jnp.int32(0)),
                                    (groups, _WIN, 3))
        acc = jax.lax.dynamic_update_slice(
            acc, cur + wacc, (jnp.int32(0), i0, jnp.int32(0)))
        _, wpix, wsamp = item_of(k)
        fresh = primary(wpix, wsamp)
        rays = tree_where(parked, fresh, rays)
        rays = type(rays)(ro=rays.ro, rd=rays.rd,
                          throughput=rays.throughput,
                          alive=rays.alive | parked)
    else:
        (rays, k, bounce, acc, segments, passes_full,
         live_now) = jax.lax.while_loop(cond1, body, state0)
    drain_passes = []

    if matmul_acc:
        # acc[g, k] holds pixel g + k*groups → transpose to pixel-major.
        # The ceil item schedule can overshoot n; the excess rows are
        # all-zero (their items were masked invalid) — slice them off.
        acc = acc.transpose(1, 0, 2).reshape(groups * acc.shape[1], 3)[:n]
    acc_flat = acc

    g_arr = lanes // jnp.uint32(spp)
    samp_arr = lanes % jnp.uint32(spp) if matmul_acc else None
    for li, lw in enumerate(levels):
        order = jnp.argsort(jnp.logical_not(rays.alive), stable=True)
        sel = order[:lw]
        g_arr = jnp.take(g_arr, sel, axis=0)
        samp_arr = jnp.take(samp_arr, sel, axis=0)
        rays = type(rays)(
            ro=jnp.take(rays.ro, sel, axis=0),
            rd=jnp.take(rays.rd, sel, axis=0),
            throughput=jnp.take(rays.throughput, sel, axis=0),
            alive=jnp.take(rays.alive, sel, axis=0),
        )
        k = jnp.take(k, sel, axis=0)
        bounce = jnp.take(bounce, sel, axis=0)

        g_cur, samp_cur = g_arr, samp_arr

        def item_of_d(kv, g_cur=g_cur, samp_cur=samp_cur):
            pixel = g_cur + kv * jnp.uint32(groups)
            valid = (kv < jnp.uint32(items_per)) & (pixel < jnp.uint32(n))
            pixel = jnp.minimum(pixel, jnp.uint32(n - 1))
            return valid, pixel, samp_cur

        next_w = levels[li + 1] if li + 1 < len(levels) else 0

        def cond_d(state, next_w=next_w):
            return state[-1] > jnp.float32(next_w)

        # drain_unroll > 1 runs that many bounce steps per while iteration
        # (steps on a drained pool are exact no-ops, so overshoot past the
        # level boundary never changes results). Ablation knob; auto is 1.
        unroll = drain_unroll if drain_unroll > 0 else 1

        def body_d(state, item_of_d=item_of_d, samp_cur=samp_cur,
                   unroll=unroll):
            rays, k, bounce, acc, segments, passes, live_now = state
            for _ in range(unroll):
                _, pixel, _ = item_of_d(k)
                rays, k, bounce, contrib, live, live_now, _pk = step(
                    rays, k, bounce, pixel, samp_cur, item_of_d)
                acc = acc.at[pixel].add(contrib)
                segments = segments + live
                passes = passes + 1.0
            return (rays, k, bounce, acc, segments, passes, live_now)

        (rays, k, bounce, acc_flat, segments, lvl_passes,
         live_now) = jax.lax.while_loop(
            cond_d, body_d,
            (rays, k, bounce, acc_flat, segments, jnp.float32(0.0), live_now))
        drain_passes.append(lvl_passes)

    if stats:
        return acc_flat, segments, {
            "pool": pool,   # actual full-width lane count (auto policy)
            "passes_full": passes_full,
            "drain_widths": tuple(levels),
            "drain_passes": tuple(drain_passes),
        }
    return acc_flat, segments

