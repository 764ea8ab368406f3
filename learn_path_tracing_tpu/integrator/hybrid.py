"""Hybrid integrator: dense primary mega-passes feeding ONE shared
persistent secondary pool.

On the reference's mesh scenes (legacy/PT_in_one_weekend/15_module.py:
36-44) the mean path length is ~1.4 segments, so most traversal work is
scanline-coherent camera rays that can be traced dense and unsorted. A
per-chunk secondary cascade would re-pay full-slab fixed costs once per spp
chunk, so this integrator traces primaries densely per chunk and gives the
secondaries the persistent pool's shape, shared across ALL chunks:

- **phase A (per spp-chunk)**: all ``n * chunk_spp`` camera rays traced in
  ONE dense, unsorted, pixel-major traversal-only pass
  (scene.legacy_world.trace_legacy — no attribute gathers, no atlas taps).
  Escape radiance accumulates with a reshape-sum over the sample axis.
- **survivor extraction**: primaries are fully regenerable from
  (pixel, sample), so the compaction sort carries only
  ``(key, work_item_id, t, prim, src)`` — 5 operands instead of the
  cohort's 15-22 — and ray state + hit attributes + the bounce-0 BSDF
  scatter are all recomputed at the compacted batch width (cap lanes,
  typically L0/8) instead of slab width.
- **phase B (shared pool)**: survivor batches from every chunk land in
  one pool of secondary rays sized to hold ALL of the render's primary
  survivors (auto ``pool_w``). In the common case each batch SPLICES into
  never-touched slots (15 column dynamic_update_slices — no sort, no
  deposits, no pool pass), so ZERO bounce passes run until every chunk
  delivered; then one end-of-render cascade traces the whole secondary
  workload at widths that track the live count (halving ``drain_ratio``
  levels). Eager make-room draining ran many pool passes at low
  occupancy; lazy fill + a ratio-2 cascade avoids that. If survivors
  overflow the pool (hit-heavy scenes past the 1M-lane cap), the
  make-room shape returns as the fallback: drain until the batch fits,
  sort-merge into dead slots — always correct, no overflow poisoning.
  A batch whose survivors exceed the batch
  width spills into multiple merge rounds either way.

Escape radiance in phase B is CARRIED per lane (``rad``) and deposited by
scatter-add only when a lane's slot is evicted (merge overwrite, cascade
narrowing, final flush) — each work item deposits at most once across the
whole render.

Per-sample radiance is bit-identical to integrator.persistent /
integrator.wavefront: the counter RNG streams are keyed on absolute
(pixel, sample, bounce) (camera rays draw STREAM_CAMERA at bounce 0, the
k-th scatter draws STREAM_BSDF at bounce k), so every path consumes exactly
the same uniforms. Only the per-pixel f32 summation order differs (~1 ulp,
the integrator family's documented freedom); traced-segment counts match
exactly (tests/test_hybrid.py).

Reference semantics covered: the wavefront propagate/scatter split of
15_module.py:980-1036 with its 32-bounce budget (:1031); phase A is the
``camera.get_rays`` + first ``propagate_once`` pair, phase B the remaining
bounce passes over the live set (the sparse-SNode compaction of
:1032-1034, realized as a sort-compacted persistent pool).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..bsdf.bsdf import SCATTERERS
from ..camera.camera import CameraParams, generate_rays_for_pixels
from ..core import rng
from ..core.types import Rays
from .wavefront import _scene_fns


def _r256(v):
    return max(-(-v // 256) * 256, 256)


@partial(jax.jit, static_argnames=("resolution", "spp", "limit", "bsdf",
                                   "camera_model", "scene", "hit_backend",
                                   "chunk_spp", "cap", "pool_w",
                                   "drain_ratio", "stats"))
def render_hybrid(world_data, cam: CameraParams, resolution, spp: int,
                  limit: int = 32, seed=0, bsdf: str = "legacy",
                  camera_model: str = "jitter", scene: str = "legacy",
                  hit_backend: str = "auto", chunk_spp: int = 0,
                  cap: int = 0, pool_w: int = 0, drain_ratio: int = 2,
                  sample_base=0, stats: bool = False):
    """Returns (image f32[W,H,3], segments f32) — same sample values as
    persistent/wavefront render; per-pixel sum order differs (~1 ulp).

    ``chunk_spp``: samples per dense primary slab (0 = auto: largest
    power-of-two divisor of spp keeping the slab under ~2M lanes).
    ``cap``: survivor batch width (0 = auto: slab/8). Batches larger than
    ``cap`` spill into multiple merge rounds — no overflow failure mode.
    ``pool_w``: secondary pool width (0 = auto: sized to hold every
    primary survivor of the whole render up to a 1M-lane cap, so
    the common case never drains mid-chunk — see _hybrid_core).
    ``drain_ratio``: narrowing ratio of the end-of-render cascade.
    ``sample_base`` (traced u32): absolute sample index of this call's
    first sample — progressive accumulation renders samples
    [sample_base, sample_base + spp) with the same RNG counters the
    one-shot render draws for them (viewer/progressive.py).
    """
    if scene != "legacy":
        raise ValueError("render_hybrid targets legacy mesh scenes; use "
                         "render_persistent for sphere scenes")
    w, h = resolution
    n = w * h
    out = _hybrid_core(world_data, cam, resolution, n, 0, sample_base, spp,
                       limit, seed, bsdf, camera_model, scene, hit_backend,
                       chunk_spp, cap, pool_w, drain_ratio, stats)
    if stats:
        acc, segments, st = out
        return (acc / spp).reshape(w, h, 3), segments, st
    acc, segments = out
    return (acc / spp).reshape(w, h, 3), segments


def _hybrid_core(world_data, cam: CameraParams, resolution, n: int,
                 pixel_base, sample_base, spp: int, limit: int, seed,
                 bsdf: str, camera_model: str, scene: str, hit_backend: str,
                 chunk_spp: int = 0, cap: int = 0, pool_w: int = 0,
                 drain_ratio: int = 2, stats: bool = False):
    """Hybrid render over a pixel range and sample range.

    Traces samples ``[sample_base, sample_base + spp)`` of pixels
    ``[pixel_base, pixel_base + n)`` of the full ``resolution`` image and
    returns ``(acc f32[n, 3] radiance sums, segments f32)``. The shard body
    for parallel.mesh's tile/spp-sharded hybrid path: phase A slabs, the
    survivor pool, merges and deposits are all local to the range — no
    cross-chip traffic until the final image gather. RNG streams key on
    absolute (pixel, sample), so per-sample radiance is reshard-invariant
    (same contract as integrator.persistent._persistent_core)."""
    from ..scene.legacy_world import shade_from_trace, trace_legacy

    pixel_base = jnp.uint32(pixel_base)
    if chunk_spp <= 0:
        chunk_spp = 1
        while spp % (chunk_spp * 2) == 0 and n * (chunk_spp * 2) <= (1 << 21):
            chunk_spp *= 2
    if spp % chunk_spp != 0:
        raise ValueError(f"chunk_spp={chunk_spp} must divide spp={spp}")
    if n * spp >= (1 << 32):
        raise ValueError("n*spp must fit u32 (work-item id packing)")
    if drain_ratio < 1:
        raise ValueError(f"drain_ratio={drain_ratio} must be >= 1 "
                         f"(cascade levels narrow by this factor)")
    n_chunks = spp // chunk_spp
    L0 = n * chunk_spp
    if cap <= 0:
        cap = _r256(L0 // 8)
    cap = min(cap, _r256(L0))
    if pool_w <= 0:
        # Size the pool to hold every primary survivor of the whole render
        # (total/8 ≈ the Yoimiya primary hit fraction with headroom),
        # bounded by a 1M-lane cap that bounds the pool sorts' scratch
        # memory. When it fits, chunks SPLICE survivor batches into
        # untouched slots and ZERO pool passes run until the end-of-render
        # cascade. Past the cap, make-room draining returns as the
        # fallback, with the pool full (high occupancy).
        pool_w = min(max(n * spp // 8, 2 * cap), 1 << 20)
    pool_w = _r256(min(pool_w, n * spp))
    pool_w = max(pool_w, cap)
    W = pool_w

    scatter = SCATTERERS[bsdf]
    hit_fn, background_fn = _scene_fns(scene)
    uspp = jnp.uint32(spp)
    sample_base = jnp.uint32(sample_base)
    cam_res = resolution

    # ---------------------------------------------------- pool machinery --
    # Pool state tuple P = 15 flat [w] columns:
    #   (ro0,ro1,ro2, rd0,rd1,rd2, th0,th1,th2, ra0,ra1,ra2, wid,bounce,alive)
    # Columns are what lax.sort wants (no stack/unstack per pool sort).
    # Every function below is width-polymorphic (drain levels reuse them).
    def _v3(c0, c1, c2):
        return jnp.stack([c0, c1, c2], axis=-1)

    def pool_pass(P, segments):
        """One COMPACTING secondary bounce pass over the pool
        (scene.legacy_world.trace_shade_compact): the pool's per-lane
        state rides a hit-compaction sort, so the pass returns the pool
        with its alive lanes inside the prefix ``[0, nhits)`` — no restoring sort, attrs on the exact
        hit count, and cascade narrowing becomes a slice. Escape radiance
        goes to the carried per-lane ``rad`` (deposited on narrowing or
        final flush), not to acc."""
        from ..scene.legacy_world import trace_shade_compact

        (ro0, ro1, ro2, rd0, rd1, rd2, th0, th1, th2,
         ra0, ra1, ra2, wid, bounce, alive) = P
        live = jnp.sum(alive.astype(jnp.float32))
        payload = (th0, th1, th2, ra0, ra1, ra2, wid, bounce, alive)
        hits, rd_c, payload_c, nhits = trace_shade_compact(
            world_data, _v3(ro0, ro1, ro2), _v3(rd0, rd1, rd2), alive,
            payload)
        (th0, th1, th2, ra0, ra1, ra2, wid, bounce, alive_c) = payload_c
        escaped = alive_c & ~hits.hit
        env = background_fn(world_data, rd_c, escaped)
        ra0 = ra0 + jnp.where(escaped, env[:, 0] * th0, 0.0)
        ra1 = ra1 + jnp.where(escaped, env[:, 1] * th1, 0.0)
        ra2 = ra2 + jnp.where(escaped, env[:, 2] * th2, 0.0)
        pix = wid // uspp + pixel_base
        smp = wid % uspp + sample_base
        base = rng.base(rng.stream(seed, smp, bounce, rng.STREAM_BSDF), pix)
        rays_c = Rays(ro=hits.point, rd=rd_c, throughput=_v3(th0, th1, th2),
                      alive=alive_c)
        sc = scatter(rays_c, hits, base)
        survived = alive_c & hits.hit & (bounce + 1 < jnp.uint32(limit))
        # dead lanes keep finite ray state: miss lanes' hits.point is the
        # original origin (t clamps to 0), rd_c is their own direction
        w_ = jnp.where
        P = (w_(survived, sc.ro[:, 0], hits.point[:, 0]),
             w_(survived, sc.ro[:, 1], hits.point[:, 1]),
             w_(survived, sc.ro[:, 2], hits.point[:, 2]),
             w_(survived, sc.rd[:, 0], rd_c[:, 0]),
             w_(survived, sc.rd[:, 1], rd_c[:, 1]),
             w_(survived, sc.rd[:, 2], rd_c[:, 2]),
             w_(survived, sc.throughput[:, 0], th0),
             w_(survived, sc.throughput[:, 1], th1),
             w_(survived, sc.throughput[:, 2], th2),
             ra0, ra1, ra2, wid,
             w_(survived, bounce + 1, bounce), survived)
        return (P, segments + live, jnp.sum(survived.astype(jnp.float32)),
                nhits)

    def sort_pool(P, dead_first: bool):
        """Payload-through-sort of the whole pool by aliveness. Columns in,
        columns out."""
        alive = P[-1]
        key = alive if dead_first else ~alive
        out = lax.sort((key.astype(jnp.uint32),) + P[:-1] + (alive,),
                       num_keys=1)
        return out[1:]

    def merge(P, bcols, batch_n, acc):
        """Place a survivor batch (cap-wide pool-order columns, valid
        prefix ``batch_n``) into the pool's dead slots. Caller guarantees
        live <= W - batch_n, so after a dead-first sort the prefix rows
        [0, batch_n) are all dead; their pending rad deposits and the
        batch overwrites them."""
        P = sort_pool(P, dead_first=True)
        ra0, ra1, ra2, wid = P[9], P[10], P[11], P[12]
        over = jnp.arange(cap, dtype=jnp.uint32) < batch_n        # [cap]
        acc = acc.at[wid[:cap] // uspp].add(
            jnp.where(over[:, None],
                      _v3(ra0[:cap], ra1[:cap], ra2[:cap]), 0.0))

        def splice(pool_f, batch_f):
            return jnp.concatenate(
                [jnp.where(over, batch_f, pool_f[:cap]), pool_f[cap:]],
                axis=0)

        return tuple(splice(pf, bf) for pf, bf in zip(P, bcols)), acc

    def run_until_live(P, segments, passes, live, threshold):
        """Pool passes until live <= threshold (the make-room fallback's
        condition: merge only needs enough DEAD slots, wherever they sit,
        because its dead-first sort gathers them)."""
        def c(st):
            return st[-1] > st[-2]

        def b(st):
            P, seg, ps, thr, live = st
            P, seg, live, _nh = pool_pass(P, seg)
            return P, seg, ps + 1.0, thr, live

        P, segments, passes, _, live = lax.while_loop(
            c, b, (P, segments, passes,
                   jnp.asarray(threshold, jnp.float32), live))
        return P, segments, passes, live

    def run_until_marker(P, segments, passes, live, marker, threshold):
        """Pool passes until the alive-containing PREFIX fits ``threshold``
        (or nothing is alive). ``marker`` bounds the prefix that can hold
        alive lanes: pool_pass hit-compacts, so after a pass it is that
        pass's ``nhits``; a freshly spliced or merged pool starts at W.
        The cascade narrows by SLICING at this guarantee — no sort."""
        def c(st):
            return (st[-1] > st[-3]) & (st[-2] > 0)

        def b(st):
            P, seg, ps, thr, live, marker = st
            P, seg, live, nh = pool_pass(P, seg)
            return P, seg, ps + 1.0, thr, live, nh

        P, segments, passes, _, live, marker = lax.while_loop(
            c, b, (P, segments, passes, jnp.asarray(threshold, jnp.int32),
                   live, marker))
        return P, segments, passes, live, marker

    def compact_slice(P, acc, lw):
        """Narrow the pool to ``lw`` rows by slicing — callers guarantee
        (via run_until_marker) that every alive lane sits in [0, lw).
        The dropped suffix is all dead; deposit its carried radiance
        (virgin never-spliced rows carry rad = 0, wid = 0 — harmless
        zero-adds to pixel 0)."""
        ra0, ra1, ra2, wid = P[9], P[10], P[11], P[12]
        acc = acc.at[wid[lw:] // uspp].add(
            _v3(ra0[lw:], ra1[lw:], ra2[lw:]))
        return tuple(f[:lw] for f in P), acc

    # ------------------------------------------------------- chunk phase --
    lanes = jnp.arange(L0, dtype=jnp.uint32)
    pixel_a = lanes // jnp.uint32(chunk_spp)

    def chunk_body(ci, carry):
        P, acc, segments, passes, live, fill = carry
        sample_a = (jnp.uint32(ci) * jnp.uint32(chunk_spp)
                    + lanes % jnp.uint32(chunk_spp))

        # ---- phase A: dense unsorted pixel-major primaries, trace only ----
        rays = generate_rays_for_pixels(cam, cam_res, pixel_a + pixel_base,
                                        seed, sample_a + sample_base,
                                        model=camera_model)
        t, prim, src = trace_legacy(world_data, rays)
        segments = segments + jnp.float32(L0)
        hitm = jnp.isfinite(t)
        esc = ~hitm
        contrib = jnp.where(
            esc[:, None],
            background_fn(world_data, rays.rd, esc) * rays.throughput, 0.0)
        acc = acc + contrib.reshape(n, chunk_spp, 3).sum(axis=1)
        if limit <= 1:
            return P, acc, segments, passes, live, fill

        # ---- survivor extraction: 3-operand sort, survivors first ----
        # t itself is the partition key: hits carry finite t > 0, misses
        # +inf, so ascending t puts survivors in a prefix (the near-to-far
        # order within it is harmless — every downstream step keys on the
        # carried work-item id). src rides prim's high bits (prim < 2^24
        # — 16.7M primitives, far above any scene here; src+1 < 128),
        # so the extraction sort carries 3 operands instead of 5.
        wid_a = pixel_a * uspp + sample_a
        count = jnp.sum(hitm.astype(jnp.uint32))
        ps = jnp.where(hitm, prim | ((src + 1) << 24), -1)
        (t_s, wid_s, ps_s) = lax.sort((t, wid_a, ps), num_keys=1)
        # pad `cap` inert rows so batch dynamic_slices never clamp/alias
        wid_s = jnp.concatenate([wid_s, jnp.zeros((cap,), jnp.uint32)])
        t_s = jnp.concatenate([t_s, jnp.full((cap,), jnp.inf, jnp.float32)])
        ps_s = jnp.concatenate([ps_s, jnp.full((cap,), -1, jnp.int32)])

        # ---- spill loop: usually one batch/chunk; any hit fraction works --
        def spill_cond(st):
            return st[0] * cap < count

        def spill_body(st):
            j, P, acc, segments, passes, live, fill = st
            off = j * jnp.uint32(cap)
            widb = lax.dynamic_slice(wid_s, (off,), (cap,))
            tb = lax.dynamic_slice(t_s, (off,), (cap,))
            psb = lax.dynamic_slice(ps_s, (off,), (cap,))
            primb = jnp.where(psb >= 0, psb & 0xFFFFFF, -1)
            srcb = jnp.where(psb >= 0, (psb >> 24) - 1, -1)
            batch_n = jnp.minimum(jnp.uint32(cap), count - off)

            # regen + deferred shading + bounce-0 scatter at batch width:
            # primaries are pure functions of (pixel, sample, seed)
            pixb = widb // uspp + pixel_base
            smpb = widb % uspp + sample_base
            raysb = generate_rays_for_pixels(cam, cam_res, pixb, seed,
                                             smpb, model=camera_model)
            validb = jnp.arange(cap, dtype=jnp.uint32) < batch_n
            hitsb = shade_from_trace(world_data, raysb,
                                     jnp.where(validb, tb, jnp.inf),
                                     primb, srcb,
                                     count=batch_n.astype(jnp.int32))
            base = rng.base(rng.stream(seed, smpb, 0, rng.STREAM_BSDF), pixb)
            scb = scatter(raysb, hitsb, base)
            w_ = jnp.where
            zc = jnp.zeros((cap,), jnp.float32)
            # batch columns in pool order (rad=0, bounce=1 added at splice):
            # dead padding rays are (ro=0, rd=(0,0,1)) — inert unit rays
            bcols = (w_(validb, scb.ro[:, 0], 0.0),
                     w_(validb, scb.ro[:, 1], 0.0),
                     w_(validb, scb.ro[:, 2], 0.0),
                     w_(validb, scb.rd[:, 0], 0.0),
                     w_(validb, scb.rd[:, 1], 0.0),
                     w_(validb, scb.rd[:, 2], 1.0),
                     w_(validb, scb.throughput[:, 0], 0.0),
                     w_(validb, scb.throughput[:, 1], 0.0),
                     w_(validb, scb.throughput[:, 2], 0.0),
                     zc, zc, zc,
                     w_(validb, widb, 0),
                     jnp.ones((cap,), jnp.uint32),
                     validb)

            # Fast path: the batch fits in never-touched slots — SPLICE it
            # (15 column dynamic_update_slices, no sort, no pool pass, no
            # deposits: overwritten rows are this render's own dead padding
            # with rad = 0). ``fill`` stays 1024-aligned by
            # rounding each advance up; the skipped <=1023 rows stay dead
            # padding.
            def do_splice(op):
                P, acc, segments, passes, live, fill = op
                f = fill.astype(jnp.int32)
                P = tuple(lax.dynamic_update_slice(pf, bf, (f,))
                          for pf, bf in zip(P, bcols))
                fill = ((fill + batch_n + jnp.uint32(1023))
                        & jnp.uint32(0xFFFFFC00))
                return P, acc, segments, passes, live, fill

            # Overflow fallback: drain the pool until the batch fits, then
            # sort-merge into dead slots (the make-room shape).
            # Once taken, live lanes are scattered anywhere — fill pins to
            # W so every later batch also takes this branch.
            def do_makeroom(op):
                P, acc, segments, passes, live, fill = op
                P, segments, passes, live = run_until_live(
                    P, segments, passes, live,
                    jnp.float32(W) - batch_n.astype(jnp.float32))
                P, acc = merge(P, bcols, batch_n, acc)
                return P, acc, segments, passes, live, jnp.uint32(W)

            can_splice = (fill + jnp.uint32(cap)) <= jnp.uint32(W)
            P, acc, segments, passes, live, fill = lax.cond(
                can_splice, do_splice, do_makeroom,
                (P, acc, segments, passes, live, fill))
            live = live + batch_n.astype(jnp.float32)
            return j + 1, P, acc, segments, passes, live, fill

        _, P, acc, segments, passes, live, fill = lax.while_loop(
            spill_cond, spill_body,
            (jnp.uint32(0), P, acc, segments, passes, live, fill))
        return P, acc, segments, passes, live, fill

    acc0 = jnp.zeros((n, 3), jnp.float32)
    zW = jnp.zeros((W,), jnp.float32)
    P0 = (zW, zW, zW,                          # ro
          zW, zW, jnp.ones((W,), jnp.float32),  # rd = (0,0,1) inert unit
          zW, zW, zW,                          # throughput
          zW, zW, zW,                          # carried rad
          jnp.zeros((W,), jnp.uint32),         # work-item id
          jnp.zeros((W,), jnp.uint32),         # bounce
          jnp.zeros((W,), bool))               # alive
    P, acc, segments, passes, live, _fill = lax.fori_loop(
        0, n_chunks, chunk_body,
        (P0, acc0, jnp.float32(0.0), jnp.float32(0.0), jnp.float32(0.0),
         jnp.uint32(0)))

    # --------------------------------------------- end-of-render cascade --
    passes_chunkphase = passes
    levels = []
    if limit > 1:
        lw = _r256(W // drain_ratio)
        while 256 <= lw < (levels[-1] if levels else W):
            levels.append(lw)
            lw = _r256(lw // drain_ratio)
    by_level = []
    marker = jnp.int32(W)   # splices leave alive lanes anywhere in [0, W)
    P, segments, passes, live, marker = run_until_marker(
        P, segments, passes, live, marker, levels[0] if levels else 0)
    by_level.append(passes)
    for li, lw in enumerate(levels):
        P, acc = compact_slice(P, acc, lw)
        marker = jnp.minimum(marker, jnp.int32(lw))
        nxt = levels[li + 1] if li + 1 < len(levels) else 0
        P, segments, passes, live, marker = run_until_marker(
            P, segments, passes, live, marker, nxt)
        by_level.append(passes)
    # final flush: every lane is dead; deposit all remaining carried rad
    acc = acc.at[P[12] // uspp].add(_v3(P[9], P[10], P[11]))

    if stats:
        # passes_by_width: [(pass width, passes run at it)] — chunk-phase
        # make-room passes at W, the cascade head (also at W), then each
        # cascade level
        widths = [W, W] + levels
        cum = [passes_chunkphase] + by_level
        per = [cum[0]] + [cum[i + 1] - cum[i] for i in range(len(cum) - 1)]
        return acc, segments, {"chunk_spp": chunk_spp, "n_chunks": n_chunks,
                               "cap": cap, "pool_w": W,
                               "levels": tuple(levels), "passes": passes,
                               "passes_chunkphase": passes_chunkphase,
                               "passes_by_width": tuple(zip(widths, per))}
    return acc, segments
