"""Texture atlas: bin-packing manager, host loaders, device samplers.

Re-implements the reference's texture stack
(/root/reference/legacy/PT_in_one_weekend/15_module.py):

- ``TextureManager`` (:456-501): guillotine 2D bin packing over a free-rect
  list; configs sorted by height then width descending; first-fit split.
- ``load_texture`` (:65-115): PBR sets (``<base>_albedo/_roughness/
  _metallic/_normal.png``) or plain images; decoded, resized, transposed to
  (u, v) with v flipped, and linearized (albedo**2.2, roughness**2,
  metallic**2, normal*2-1).
- ``load_environment`` (:118-132): equirect EXR (HDR) or PNG/255 maps.
- ``nearest``/``bilinear`` (:226-258): atlas samplers with wrap-around inside
  each texture's rect. The reference's bilinear wraps the v axis with the
  *u* extent (a copy-paste bug, :255-256) — we wrap correctly; for square
  textures (all the shipped assets) the two are identical.

Device layout: one packed ``f32[W, H, 8]`` atlas (albedo rgb, normal xyz,
roughness, metallic) so a bilinear tap is 4 gathers of 8 contiguous floats.
Missing texture files (the reference repo ships with large blobs stripped)
fall back to a neutral material with a warning instead of crashing.
"""

from __future__ import annotations

import os
import warnings

import jax.numpy as jnp
import numpy as np

from ..core.pytree import pytree_dataclass


# ---------------------------------------------------------------- packing --

class TextureManager:
    """Guillotine bin packer for atlas rectangles.

    Compatibility constraint: placements must reproduce the reference
    packer's decisions exactly (15_module.py:456-501 semantics — tallest-
    first order, first-fit over the free list, band split with the right
    sliver scanned before the upper band), because packed rects are
    serialized into ``.world.npy`` files and sampled by rect coordinates.
    The implementation below is our own; only the decision procedure is
    pinned by the file format.
    """

    def __init__(self, size):
        self.size = (int(size[0]), int(size[1]))
        self.configs: list[dict] = []
        # free regions as (x, y, w, h) tuples, scanned front-to-back
        self._free: list[tuple[int, int, int, int]] = []

    def add(self, file_path, id, size=None):
        if size is None:
            size = _probe_size(file_path)
        self.configs.append({"file_path": file_path,
                             "size": (int(size[0]), int(size[1])),
                             "id": int(id)})

    def clear(self):
        self.configs = []

    def _place(self, w, h):
        """First-fit placement; splits the chosen region into a right
        sliver (same height band, scanned first) and the band above."""
        for i, (x, y, fw, fh) in enumerate(self._free):
            if fw < w or fh < h:
                continue
            self._free[i:i + 1] = [(x + w, y, fw - w, h),
                                   (x, y + h, fw, fh - h)]
            return {"low": (x, y), "high": (x + w, y + h)}
        return None

    def build(self):
        self._free = [(0, 0, self.size[0], self.size[1])]
        # tallest first, widest as tiebreaker (stable for equal sizes)
        self.configs.sort(key=lambda c: (-c["size"][1], -c["size"][0]))
        for cfg in self.configs:
            area = self._place(*cfg["size"])
            if area is None:
                raise MemoryError(
                    "texture atlas full: no free region fits "
                    f"{cfg['size']} (atlas {self.size})")
            cfg["area"] = area

    def dump(self):
        return {"size": self.size, "configs": self.configs}

    def load(self, data):
        self.size = tuple(data["size"])
        self.configs = []
        for cfg in data["configs"]:
            area = cfg["area"]
            low = tuple(int(x) for x in _area_field(area, "low"))
            high = tuple(int(x) for x in _area_field(area, "high"))
            self.configs.append({
                "file_path": cfg["file_path"],
                "size": tuple(cfg["size"]),
                "id": int(cfg["id"]),
                "area": {"low": low, "high": high},
            })


def _area_field(area, key):
    """Extract low/high from our dict form or a shimmed taichi Struct."""
    if isinstance(area, dict):
        v = area[key]
    else:  # serialize.py shim object
        v = area[key]
    if hasattr(v, "entries"):
        v = v.entries
    return tuple(v)


def _probe_size(file_path):
    path = file_path if os.path.exists(file_path) else file_path + "_albedo.png"
    if path.endswith(".exr"):
        from .exr import read_exr

        arr = read_exr(path)
        return (arr.shape[1], arr.shape[0])  # (w, h)
    with _pil_image().open(path) as img:
        return img.size  # (w, h)


# ------------------------------------------------------------ host loaders --

def _pil_image():
    """PIL's ``Image`` module, imported only when a texture image is loaded
    (mesh scenes); the sphere scenes and PNG output never need it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "loading texture images needs Pillow (PIL), which is not "
            "installed; sphere scenes and PNG output do not need it") from e
    return Image


def _decode(path, size, mode=None):
    Image = _pil_image()
    img = Image.open(path)
    if mode:
        img = img.convert(mode)
    img = img.resize(size, Image.LANCZOS)
    a = np.asarray(img, np.float32) / 255.0
    if a.ndim == 3:
        a = a.transpose(1, 0, 2)[..., :3]
        return np.flip(a, 1)
    return np.flip(a.transpose(1, 0), 1)


def build_texture_atlas(configs, atlas_size, path_map=None) -> np.ndarray:
    """Fill a packed ``f32[W, H, 8]`` atlas from packing configs.

    ``path_map(file_path) -> str`` rewrites stored (possibly relative)
    paths; missing files produce a neutral gray material + warning.
    """
    w, h = atlas_size
    atlas = np.zeros((w, h, 8), np.float32)
    atlas[..., 7] = 0.0
    for cfg in configs:
        low = _area_field(cfg["area"], "low")
        high = _area_field(cfg["area"], "high")
        size = (high[0] - low[0], high[1] - low[1])
        path = cfg["file_path"]
        if path_map is not None:
            path = path_map(path)
        try:
            if os.path.exists(path):
                albedo = _decode(path, size)
                roughness = np.ones(size, np.float32)
                metallic = np.zeros(size, np.float32)
                normal = np.broadcast_to(
                    np.array([0.5, 0.5, 1.0], np.float32), (*size, 3)).copy()
            elif os.path.exists(path + "_albedo.png"):
                albedo = _decode(path + "_albedo.png", size)
                roughness = _decode(path + "_roughness.png", size, "L")
                metallic = _decode(path + "_metallic.png", size, "L")
                normal = _decode(path + "_normal.png", size)
            else:
                raise FileNotFoundError(path)
        except FileNotFoundError:
            warnings.warn(f"texture missing, using neutral fill: {path}")
            albedo = np.full((*size, 3), 0.5, np.float32)
            roughness = np.ones(size, np.float32)
            metallic = np.zeros(size, np.float32)
            normal = np.broadcast_to(
                np.array([0.5, 0.5, 1.0], np.float32), (*size, 3)).copy()

        sl = np.s_[low[0]:high[0], low[1]:high[1]]
        atlas[sl][..., 0:3] = albedo ** 2.2
        atlas[sl][..., 3:6] = normal * 2.0 - 1.0
        atlas[sl][..., 6] = roughness ** 2
        atlas[sl][..., 7] = metallic ** 2
    return atlas


def build_environment_atlas(configs, atlas_size, path_map=None):
    """Fill an equirect environment atlas ``f32[W, H, 3]`` (linear HDR).

    Returns ``(atlas, gradient_ids)`` where ``gradient_ids`` is the set of
    config ids whose source file was missing/undecodable and therefore hold
    the procedural sky gradient — callers can route those through the
    analytic gradient evaluation instead of atlas taps (environment_color's
    ``gradient_h`` fast path; the tap costs two row gathers per lane for
    what is a 6-op closed form)."""
    w, h = atlas_size
    atlas = np.zeros((w, h, 3), np.float32)
    gradient_ids = set()
    for cfg in configs:
        low = _area_field(cfg["area"], "low")
        high = _area_field(cfg["area"], "high")
        size = (high[0] - low[0], high[1] - low[1])
        path = cfg["file_path"]
        if path_map is not None:
            path = path_map(path)
        env = None
        if os.path.exists(path):
            if path.endswith(".exr"):
                try:
                    from .exr import read_exr

                    env = np.asarray(read_exr(path), np.float32)[..., :3]
                except Exception as e:
                    warnings.warn(f"EXR decode failed ({e}): {path}")
            else:
                env = np.asarray(_pil_image().open(path).convert("RGB"),
                                 np.float32) / 255.0
        if env is None:
            warnings.warn(f"environment missing, using sky gradient: {path}")
            gradient_ids.add(int(cfg["id"]))
            # vertical white→blue gradient like the modern stages
            v = np.linspace(0.0, 1.0, size[1], dtype=np.float32)
            top = np.array([0.5, 0.7, 1.0], np.float32)
            bottom = np.array([1.0, 1.0, 1.0], np.float32)
            grad = bottom[None] * (1 - v)[:, None] + top[None] * v[:, None]
            env_uv = np.broadcast_to(grad[None, :, :], (*size, 3)).copy()
        else:
            if env.shape[:2][::-1] != size:
                # resize via PIL on the HDR data channel-wise is lossy; use
                # simple nearest for robustness
                import numpy as _np

                ys = (_np.linspace(0, env.shape[0] - 1, size[1])).astype(int)
                xs = (_np.linspace(0, env.shape[1] - 1, size[0])).astype(int)
                env = env[ys][:, xs]
            env_uv = np.flip(env.transpose(1, 0, 2)[..., :3], 1)
        atlas[low[0]:high[0], low[1]:high[1]] = env_uv
    return atlas, frozenset(gradient_ids)


# ---------------------------------------------------------- device sampler --

@pytree_dataclass
class TextureAtlas:
    """Packed material atlas + per-texture rects (device arrays)."""

    packed: jnp.ndarray     # f32[W, H, 8]
    info_low: jnp.ndarray   # i32[K, 2]
    info_high: jnp.ndarray  # i32[K, 2]


@pytree_dataclass
class EnvironmentMaps:
    img: jnp.ndarray        # f32[W, H, 3]
    info_low: jnp.ndarray   # i32[K, 2]
    info_high: jnp.ndarray  # i32[K, 2]


def make_info_arrays(configs, max_id=None):
    """Pack configs' areas into dense [K,2] low/high arrays indexed by id."""
    ids = [cfg["id"] for cfg in configs]
    k = (max(ids) + 1) if ids else 1
    if max_id is not None:
        k = max(k, max_id + 1)
    low = np.zeros((k, 2), np.int32)
    high = np.ones((k, 2), np.int32)
    for cfg in configs:
        low[cfg["id"]] = _area_field(cfg["area"], "low")
        high[cfg["id"]] = _area_field(cfg["area"], "high")
    return jnp.asarray(low), jnp.asarray(high)


def _gather2d(img, x, y):
    """img [W,H,C]; x,y i32[N] → f32[N,C] (flat gather, one pass).

    The atlas may be stored bfloat16 (texture sources are 8-bit, so bf16's
    mantissa is lossless headroom; halves the random-gather traffic that
    dominates tap cost) — blend weights are always applied in f32."""
    w, h = img.shape[0], img.shape[1]
    flat = img.reshape(w * h, img.shape[2])
    return jnp.take(flat, x * h + y, axis=0).astype(jnp.float32)


def sample_bilinear(img, info_low, info_high, tex_id, u, v):
    """Bilinear atlas tap with per-rect wrap-around (15_module.py:239-258,
    with the v-wrap fixed). ``tex_id: i32[N]``, ``u, v: f32[N]``.
    Returns ``f32[N, C]``."""
    low = jnp.take(info_low, tex_id, axis=0)
    high = jnp.take(info_high, tex_id, axis=0)
    wpix = (high[:, 0] - low[:, 0])
    hpix = (high[:, 1] - low[:, 1])
    uu = u * wpix.astype(jnp.float32) - 0.5
    vv = v * hpix.astype(jnp.float32) - 0.5
    l = uu.astype(jnp.int32)   # trunc-toward-zero, as ti.cast does
    r = l + 1
    b = vv.astype(jnp.int32)
    t = b + 1
    wl = (r.astype(jnp.float32) - uu)
    wb = (t.astype(jnp.float32) - vv)
    lb = wl * wb
    lt = wl * (1.0 - wb)
    rb = (1.0 - wl) * wb
    rt = (1.0 - wl) * (1.0 - wb)
    lw = low[:, 0] + jnp.mod(l, wpix)
    rw = low[:, 0] + jnp.mod(r, wpix)
    bw = low[:, 1] + jnp.mod(b, hpix)
    tw = low[:, 1] + jnp.mod(t, hpix)
    return (lb[:, None] * _gather2d(img, lw, bw)
            + lt[:, None] * _gather2d(img, lw, tw)
            + rb[:, None] * _gather2d(img, rw, bw)
            + rt[:, None] * _gather2d(img, rw, tw))


def sample_nearest(img, info_low, info_high, tex_id, u, v):
    """Nearest atlas tap (15_module.py:226-235)."""
    low = jnp.take(info_low, tex_id, axis=0)
    high = jnp.take(info_high, tex_id, axis=0)
    wpix = (high[:, 0] - low[:, 0])
    hpix = (high[:, 1] - low[:, 1])
    x = (u * wpix.astype(jnp.float32)).astype(jnp.int32)
    y = (v * hpix.astype(jnp.float32)).astype(jnp.int32)
    x = low[:, 0] + jnp.mod(x, wpix)
    y = low[:, 1] + jnp.mod(y, hpix)
    return _gather2d(img, x, y)


# ------------------------------------------------- strip-packed fast taps --
#
# A bilinear tap as 4 independent texel gathers costs four random row
# fetches per lane, where widening a row costs little. Strip
# packing stores runs of T horizontally-adjacent texels per row with a
# one-texel overlap between consecutive strips (stride T-1), u-wrap baked
# in cyclically per texture rect — so the two texels (l, l+1) of a
# bilinear footprint ALWAYS live in one row, and a full tap is 2 gathers
# (v-levels b, b+1) from a table with ~T-fold fewer rows.


@pytree_dataclass
class StripAtlas:
    """Strip-packed atlas + per-texture rects and strip indexing."""

    table: jnp.ndarray      # [R, T*C] (bf16 material / f32 env)
    info_low: jnp.ndarray   # i32[K, 2] rect coords in the virtual atlas
    info_high: jnp.ndarray  # i32[K, 2]
    base: jnp.ndarray       # i32[K] first table row of each rect
    spr: jnp.ndarray        # i32[K] strips per texel row of each rect
    # packed per-texture row (w, h, base, spr) — the sampler reads this with
    # ONE row gather instead of four element takes
    info: jnp.ndarray       # i32[K, 4]


def pack_strips(atlas_np, info_low, info_high, texels: int,
                dtype=None) -> StripAtlas:
    """Strip-pack ``atlas_np [W, H, C]`` per texture rect.

    Row layout is texel-major: ``row[j*C:(j+1)*C]`` is texel ``x0+j`` (mod
    rect width — the wrap bakes the reference's repeat addressing into the
    table). Rect rows are laid out y-major: row index =
    ``base + y * spr + strip``.

    Each table row carries BOTH texel rows of a bilinear tap: columns
    ``[0, T*C)`` are texel row ``y``, columns ``[T*C, 2*T*C)`` are texel row
    ``(y+1) mod h`` (the v-wrap baked in). Storage doubles, but a full
    bilinear tap becomes ONE random row gather instead of four.
    """
    low = np.asarray(info_low)
    high = np.asarray(info_high)
    c = atlas_np.shape[2]
    stride = texels - 1
    k = low.shape[0]
    base = np.zeros((k,), np.int32)
    spr = np.zeros((k,), np.int32)
    total = 0
    for i in range(k):
        w = int(high[i, 0] - low[i, 0])
        h = int(high[i, 1] - low[i, 1])
        base[i] = total
        spr[i] = -(-w // stride)
        total += h * int(spr[i])
    table = np.zeros((max(total, 1), 2 * texels * c), np.float32)
    for i in range(k):
        x0, y0 = int(low[i, 0]), int(low[i, 1])
        w = int(high[i, 0] - x0)
        h = int(high[i, 1] - y0)
        rect = atlas_np[x0:x0 + w, y0:y0 + h]          # [w, h, C]
        # cyclic x indices for every strip slot: [spr, texels]
        s = int(spr[i])
        xs = (np.arange(s)[:, None] * stride + np.arange(texels)[None]) % w
        # [s, texels, h, C] -> rows [h * s, texels * C] y-major
        block = rect[xs]                               # [s, texels, h, C]
        block = block.transpose(2, 0, 1, 3).reshape(h * s, texels * c)
        # pair each row with its v-wrapped successor row
        succ = np.roll(np.arange(h), -1)               # y+1 mod h
        block_t = block.reshape(h, s, texels * c)[succ].reshape(
            h * s, texels * c)
        table[base[i]:base[i] + h * s] = np.concatenate(
            [block, block_t], axis=1)
    if dtype is None:
        dtype = jnp.float32
    info = np.stack([high[:, 0] - low[:, 0], high[:, 1] - low[:, 1],
                     base, spr], axis=1).astype(np.int32)
    return StripAtlas(table=jnp.asarray(table, dtype),
                      info_low=jnp.asarray(low.astype(np.int32)),
                      info_high=jnp.asarray(high.astype(np.int32)),
                      base=jnp.asarray(base), spr=jnp.asarray(spr),
                      info=jnp.asarray(info))


def _imod_f32(a, m):
    """``mod(a, m)`` for i32 values via f32 arithmetic (exact while
    |a|, m < 2^23 — texture coords are bounded by rect sizes times the UV
    wrap count, orders of magnitude below that). Dynamic-divisor integer
    division has no VPU hardware path and lowers to a long multi-op
    sequence; f32 divide + floor is a handful of ops."""
    af = a.astype(jnp.float32)
    mf = jnp.maximum(m.astype(jnp.float32), 1.0)  # degenerate rect guard
    q = jnp.floor(af / mf)
    return (af - q * mf).astype(jnp.int32)


def sample_bilinear_strips(atlas: StripAtlas, tex_id, u, v, channels: int):
    """Bilinear tap over a strip-packed atlas — identical texels and weights
    to ``sample_bilinear`` (same rect wrap-around), ONE row gather instead
    of 4 (rows carry both y and y+1, see pack_strips). ``channels`` must be
    static (table width = 2 * T * channels)."""
    c = channels
    texels = atlas.table.shape[1] // (2 * c)
    stride = texels - 1
    if atlas.info.shape[0] == 1:
        # single-texture atlas (every character world ships one material
        # texture): the per-lane info-row gather is a constant — broadcast
        # row 0 instead of paying a latency-bound N-row take
        info = jnp.broadcast_to(atlas.info[0][None, :],
                                (u.shape[0], atlas.info.shape[1]))
    else:
        info = jnp.take(atlas.info, tex_id, axis=0)    # one row gather
    wpix, hpix, base, spr = (info[:, 0], info[:, 1], info[:, 2], info[:, 3])
    uu = u * wpix.astype(jnp.float32) - 0.5
    vv = v * hpix.astype(jnp.float32) - 0.5
    l = uu.astype(jnp.int32)   # trunc-toward-zero, as ti.cast does
    b = vv.astype(jnp.int32)
    wl = ((l + 1).astype(jnp.float32) - uu)[:, None]
    wb = ((b + 1).astype(jnp.float32) - vv)[:, None]
    lm = _imod_f32(l, wpix)
    sx = lm // stride
    off = lm - sx * stride
    by = _imod_f32(b, hpix)
    tc = texels * c
    pair_row = jnp.take(atlas.table, base + by * spr + sx, axis=0)
    row_b, row_t = pair_row[:, :tc], pair_row[:, tc:]
    row = (wb * row_b.astype(jnp.float32)
           + (1.0 - wb) * row_t.astype(jnp.float32))   # [N, T*C]
    # texel pair (off, off+1) via a one-hot sum of static slices
    pair = jnp.zeros((u.shape[0], 2 * c), jnp.float32)
    for j in range(stride):
        m = (off == j).astype(jnp.float32)[:, None]
        pair = pair + m * row[:, j * c:(j + 2) * c]
    return wl * pair[:, :c] + (1.0 - wl) * pair[:, c:]
