"""Wide (8-ary) BVH: collapse + lockstep wavefront traversal.

Wavefront acceleration layout: the reference's binary BVH walks ~60-100
nodes per ray with one AABB test each (15_module.py:756-779) — in lockstep
it is far better to test 8 sibling AABBs per step (one fused elementwise
block) and cut the iteration count by ~3x, which also slashes the
per-iteration gather count (one wide-node row instead of many binary rows).

Host side, a binary FlatBVH (accel/bvh.py) is collapsed by repeatedly
expanding the largest-area frontier entry until each wide node has up to 8
children; children are either inner wide nodes or leaf runs (contiguous
prim ranges in the shared ``prim`` list, capped at ``max_run`` prims).

Device side, traversal runs the same lockstep while_loop as
accel/traverse.py but with stack entries encoding either a wide-node index
(``>= 0``) or a leaf run (``-(start * 64 + count + 1)``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.pytree import pytree_dataclass
from ..geometry.aabb import EPSILON
from .bvh import FlatBVH

WIDTH = 8
# Leaf-run length cap. The stack encoding allows up to 63, but the traversal
# unrolls `max_leaf` primitive tests on EVERY iteration — fat runs (e.g. the
# reference's depth-capped 63-prim leaves) multiply per-iteration gather
# traffic ~16x. 8 balances unroll cost against extra stack pushes.
DEFAULT_MAX_RUN = 8
_ENC = 64  # run-length field width in the encoding

_PAD = np.int32(-(2 ** 30))


def _encode_leaf(start: int, count: int) -> int:
    return -(start * _ENC + count + 1)


def decode_leaf(code):
    """code i32[N] → (start, count) for leaf entries (code < 0, != PAD)."""
    v = -(code + 1)
    return v // _ENC, v % _ENC


@pytree_dataclass(meta_fields=("depth", "max_leaf"))
class WideBVH:
    child_low: jnp.ndarray    # f32[M, 8, 3]
    child_high: jnp.ndarray   # f32[M, 8, 3]
    child_entry: jnp.ndarray  # i32[M, 8] — node idx >=0 | leaf-run code | PAD
    prim: jnp.ndarray         # i32[P] leaf-ordered primitive indices
    depth: int                # max wide-tree depth (stack sizing)
    max_leaf: int             # longest leaf run (<= 63)


def collapse(flat: FlatBVH, max_run: int = DEFAULT_MAX_RUN) -> WideBVH:
    assert 1 <= max_run < _ENC
    left = np.asarray(flat.left)
    right = np.asarray(flat.right)
    low = np.asarray(flat.low)
    high = np.asarray(flat.high)
    data = np.asarray(flat.data)
    cut = np.asarray(flat.cut)

    def area(i):
        s = np.maximum(high[i] - low[i], 0)
        return float(s[0] * s[1] + s[1] * s[2] + s[2] * s[0])

    def slots_needed(e: int) -> int:
        if data[e] < 0:
            return 1
        prims = int(cut[data[e] + 1] - cut[data[e]])
        return max(1, -(-prims // max_run))

    def frontier(b: int) -> list[int]:
        if data[b] >= 0:
            entries = [b]
        else:
            entries = [int(left[b]), int(right[b])]
        while True:
            total = sum(slots_needed(e) for e in entries)
            expandable = [
                e for e in entries if data[e] < 0 and
                total - 1 + slots_needed(int(left[e]))
                + slots_needed(int(right[e])) <= WIDTH
            ]
            if not expandable:
                return entries
            pick = max(expandable, key=area)
            k = entries.index(pick)
            entries[k:k + 1] = [int(left[pick]), int(right[pick])]

    # Phase 1: frontier selection per wide node (BFS over binary nodes).
    wide_children: list[list[int]] = []
    binary_of_wide: list[int] = []
    wide_of_binary: dict[int, int] = {}
    queue = [0]
    depth_of = {0: 0}
    max_depth = 0
    while queue:
        b = queue.pop(0)
        wide_of_binary[b] = len(wide_children)
        kids = frontier(b)
        wide_children.append(kids)
        binary_of_wide.append(b)
        for e in kids:
            if data[e] < 0:
                queue.append(e)
                depth_of[e] = depth_of[b] + 1
                max_depth = max(max_depth, depth_of[e])

    # Phase 2: flatten each wide node's children into slot entries.
    # ('leaf', s, c, bin) | ('bin', bin) | ('cont', out_idx). Nodes whose
    # content exceeds 8 slots chain into continuation nodes (slot 7 links).
    out_slots: list[list[tuple]] = []
    out_of_wide: dict[int, int] = {}
    actual_max_run = 1
    extra_depth = 0

    for w, kids in enumerate(wide_children):
        entries: list[tuple] = []
        for e in kids:
            if data[e] >= 0:
                start = int(cut[data[e]])
                end = int(cut[data[e] + 1])
                s = start
                while s < end:
                    c = min(max_run, end - s)
                    entries.append(("leaf", s, c, e))
                    actual_max_run = max(actual_max_run, c)
                    s += c
            else:
                entries.append(("bin", e))
        out_of_wide[w] = len(out_slots)
        chain = 0
        while True:
            if len(entries) <= WIDTH:
                out_slots.append(entries)
                break
            head = entries[: WIDTH - 1]
            rest = entries[WIDTH - 1:]
            cont_idx = len(out_slots) + 1
            out_slots.append(head + [("cont", cont_idx)])
            entries = rest
            chain += 1
        extra_depth = max(extra_depth, chain)

    m = len(out_slots)
    child_low = np.full((m, WIDTH, 3), np.inf, dtype=np.float32)
    child_high = np.full((m, WIDTH, 3), -np.inf, dtype=np.float32)
    child_entry = np.full((m, WIDTH), _PAD, np.int32)

    for o, entries in enumerate(out_slots):
        for slot, ent in enumerate(entries):
            if ent[0] == "leaf":
                _, s, c, e = ent
                child_low[o, slot] = low[e]
                child_high[o, slot] = high[e]
                child_entry[o, slot] = _encode_leaf(s, c)
            elif ent[0] == "bin":
                e = ent[1]
                child_low[o, slot] = low[e]
                child_high[o, slot] = high[e]
                child_entry[o, slot] = out_of_wide[wide_of_binary[e]]
            else:  # continuation: AABB = union of its remaining entries
                cont = ent[1]
                lo = np.full(3, np.inf, np.float32)
                hi = np.full(3, -np.inf, np.float32)
                stackq = [cont]
                while stackq:
                    oi = stackq.pop()
                    for e2 in out_slots[oi]:
                        if e2[0] == "cont":
                            stackq.append(e2[1])
                        else:
                            b2 = e2[3] if e2[0] == "leaf" else e2[1]
                            lo = np.minimum(lo, low[b2])
                            hi = np.maximum(hi, high[b2])
                child_low[o, slot] = lo
                child_high[o, slot] = hi
                child_entry[o, slot] = cont

    return WideBVH(
        child_low=jnp.asarray(child_low),
        child_high=jnp.asarray(child_high),
        child_entry=jnp.asarray(child_entry),
        prim=flat.prim,
        depth=int(max_depth) + 1 + int(extra_depth) + 1,
        max_leaf=int(actual_max_run),
    )


# Batcher odd-even merge network for 8 elements (19 compare-exchanges).
_SORT8 = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
          (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
          (1, 2), (3, 4), (5, 6)]


def _sort8_by_key(key, val):
    """Sort 8 (key, val) columns ascending by key — a vectorized sorting
    network over [N, 8] arrays (19 masked swaps, all VPU)."""
    for a, b in _SORT8:
        swap = key[:, a] > key[:, b]
        ka = jnp.where(swap, key[:, b], key[:, a])
        kb = jnp.where(swap, key[:, a], key[:, b])
        va = jnp.where(swap, val[:, b], val[:, a])
        vb = jnp.where(swap, val[:, a], val[:, b])
        key = key.at[:, a].set(ka).at[:, b].set(kb)
        val = val.at[:, a].set(va).at[:, b].set(vb)
    return key, val


def traverse_wide(wbvh: WideBVH, ro, rd, leaf_test, eps: float = EPSILON,
                  t_init=None):
    """Nearest-hit over a WideBVH; same contract as accel.traverse.traverse.

    Beyond the reference's unordered walk, this is an *ordered* DFS: hit
    children are pushed near-to-far (8-wide sorting network on slab entry
    distances) with their entry distance kept on a parallel f32 stack, and
    popped entries whose recorded distance can no longer beat the current
    best hit are discarded without any gathers — together these convert the
    lockstep walk into best-first traversal and cut iteration counts by
    multiples on deep meshes. Hit results are unchanged (pruning only skips
    provably non-improving subtrees).
    """
    from .traverse import stack_read, stack_write

    n = ro.shape[0]
    cap = wbvh.depth * (WIDTH - 1) + 3
    n_prim = wbvh.prim.shape[0]
    max_leaf = wbvh.max_leaf

    flat_low = wbvh.child_low.reshape(-1, WIDTH * 3)
    flat_high = wbvh.child_high.reshape(-1, WIDTH * 3)
    inv = 1.0 / rd

    def cond(state):
        # state = (stack, stack_t, sp, t_best, prim_best); terminate when
        # every lane's stack pointer has popped below 0. (Not state[1]: the
        # f32 distance stack's entries are >= 0 forever, so testing it
        # would never end the loop.)
        return jnp.any(state[2] >= 0)

    def body(state):
        stack, stack_t, sp, t_best, prim_best = state
        active = sp >= 0
        slot = jnp.clip(sp, 0, cap - 1)
        cur = stack_read(stack, slot)
        cur_t0 = stack_read(stack_t, slot)
        fresh = active & (cur_t0 < t_best + eps)  # stale entries just pop
        is_node = fresh & (cur >= 0)
        is_leaf = fresh & (cur < 0) & (cur != _PAD)

        # ---- leaf runs: up to max_leaf primitive tests ----
        start, count = decode_leaf(jnp.where(is_leaf, cur, jnp.int32(-1)))
        for k in range(max_leaf):
            pidx = jnp.take(wbvh.prim,
                            jnp.clip(start + k, 0, max(n_prim - 1, 0)), axis=0)
            valid = is_leaf & (k < count)
            t = leaf_test(pidx, valid, ro, rd)
            better = valid & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            prim_best = jnp.where(better, pidx, prim_best)

        # ---- wide nodes: test 8 child AABBs, push hits ----
        node = jnp.maximum(cur, 0)
        clow = jnp.take(flat_low, node, axis=0).reshape(n, WIDTH, 3)
        chigh = jnp.take(flat_high, node, axis=0).reshape(n, WIDTH, 3)
        entry = jnp.take(wbvh.child_entry, node, axis=0)        # [N,8]

        ti_ = (clow - ro[:, None, :]) * inv[:, None, :]
        to_ = (chigh - ro[:, None, :]) * inv[:, None, :]
        t1 = jnp.min(jnp.maximum(ti_, to_), axis=-1)
        t0 = jnp.max(jnp.minimum(ti_, to_), axis=-1)
        hit8 = (t1 > t0 - eps) & (t1 > 0.0) & (entry != _PAD) \
            & (t0 < t_best[:, None] + eps) & is_node[:, None]     # [N,8]

        # near-to-far ordering: sort (t0, entry) ascending; missed slots get
        # +inf keys and sink to the tail, so slot 0 = nearest hit child.
        key = jnp.where(hit8, jnp.maximum(t0, 0.0), jnp.inf)
        key, entry_sorted = _sort8_by_key(key, entry)
        hit_sorted = jnp.isfinite(key)

        push_count = jnp.sum(hit_sorted.astype(jnp.int32), axis=1)
        new_sp = jnp.where(
            active, sp - 1 + jnp.where(is_node, push_count, 0), sp)

        # push so slot 0 ends on top (near child processed next):
        # slot k lands at (sp - 1 + #hit slots with index >= k)
        suffix = jnp.cumsum(
            hit_sorted[:, ::-1].astype(jnp.int32), axis=1)[:, ::-1]
        for k in range(WIDTH):
            pos = jnp.clip(sp - 1 + suffix[:, k], 0, cap - 1)
            stack = stack_write(stack, pos, entry_sorted[:, k], hit_sorted[:, k])
            stack_t = stack_write(stack_t, pos, key[:, k], hit_sorted[:, k])
        return stack, stack_t, new_sp, t_best, prim_best

    stack0 = jnp.full((n, cap), _PAD, jnp.int32).at[:, 0].set(0)
    stack_t0 = jnp.zeros((n, cap), jnp.float32)  # root entry distance 0
    sp0 = jnp.zeros((n,), jnp.int32)
    t0_ = (jnp.full((n,), jnp.inf, jnp.float32) if t_init is None
           else jnp.asarray(t_init))
    p0 = jnp.full((n,), -1, jnp.int32)
    _, _, _, t_best, prim_best = jax.lax.while_loop(
        cond, body, (stack0, stack_t0, sp0, t0_, p0))
    return t_best, prim_best
