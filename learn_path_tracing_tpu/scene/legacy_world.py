"""Legacy-line world: textured triangle meshes + spheres + IBL environment.

Mirrors the reference's module-15 ``World``
(/root/reference/legacy/PT_in_one_weekend/15_module.py:782-848): a sphere
BVH plus one BVH per mesh, materials sampled from the texture atlas at hit
time, an equirect environment as the escape radiance, and ``.world.npy``
save/load. Device design: flat SoA device tables per mesh (pre-gathered
per-face vertex data so traversal leaf tests need a single index), masked
wavefront hit queries, and a packed 8-channel atlas with one bilinear
sampler for all material channels.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..accel.bvh import FlatBVH, build_bvh
from ..accel.traverse import (
    make_sphere_leaf_test,
    make_triangle_leaf_test,
    traverse,
)
from ..accel.wide import WideBVH, collapse, traverse_wide
from ..core.pytree import pytree_dataclass
from ..core.types import Hits, Materials, Rays
from ..io.obj import MeshData
from ..io.texture import (
    StripAtlas,
    TextureManager,
    build_environment_atlas,
    build_texture_atlas,
    make_info_arrays,
    pack_strips,
    sample_bilinear_strips,
)
from . import serialize

EPSILON = 1e-4
# Legacy constants baked into hit records (15_module.py:891-894, 946-950).
LEGACY_IOR = 1.5
LEGACY_ABSORPTIVITY = 0.25



@pytree_dataclass
class MeshDeviceData:
    v0: jnp.ndarray   # f32[T,3] pre-gathered vertex positions
    v1: jnp.ndarray
    v2: jnp.ndarray
    n0: jnp.ndarray   # f32[T,3] vertex normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    uv0: jnp.ndarray  # f32[T,2]
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    tex: jnp.ndarray  # i32[T]
    bvh: FlatBVH
    wide: object = None    # WideBVH | None — 8-ary layout for traversal


@pytree_dataclass
class SphereDeviceData:
    center: jnp.ndarray        # f32[S,3]
    radius: jnp.ndarray        # f32[S]
    transparency: jnp.ndarray  # f32[S]
    tex: jnp.ndarray           # i32[S]
    bvh: FlatBVH


@pytree_dataclass(meta_fields=("env_gradient_h",))
class LegacyWorldData:
    meshes: tuple            # tuple[MeshDeviceData, ...]
    spheres: SphereDeviceData | None
    atlas: StripAtlas        # material atlas, strip-packed bf16 (8 channels)
    envs: StripAtlas         # equirect environments, strip-packed f32 (3 ch)
    env_id: jnp.ndarray      # i32 scalar
    # Deferred-shading table: all meshes' per-triangle attributes packed into
    # one row-per-triangle array so the post-traversal shading pass costs ONE
    # gather regardless of mesh count. Columns: v0 v1 v2 (9), n0 n1 n2 (9),
    # uv0 uv1 uv2 (6), tex (1, f32-encoded id), pad → 32.
    tri_attr: jnp.ndarray | None = None   # f32[sum(T_k), 32]
    # Static (pytree-aux): when the ACTIVE environment's source file was
    # missing, its atlas rect holds the procedural sky gradient — this is
    # its baked rect height, letting environment_color evaluate the tap
    # analytically (closed form in rd, zero gathers) instead of via two
    # row gathers per lane. None = a real environment image is loaded.
    env_gradient_h: int | None = None


def _mesh_device(positions, normals, uvs, face_p, face_n, face_t, face_tex,
                 bvh: FlatBVH) -> MeshDeviceData:
    p = positions[face_p]          # [T,3,3]
    n = normals[face_n]
    t = uvs[face_t]
    j = jnp.asarray
    wide = collapse(bvh)
    return MeshDeviceData(
        v0=j(p[:, 0]), v1=j(p[:, 1]), v2=j(p[:, 2]),
        n0=j(n[:, 0]), n1=j(n[:, 1]), n2=j(n[:, 2]),
        uv0=j(t[:, 0]), uv1=j(t[:, 1]), uv2=j(t[:, 2]),
        tex=j(face_tex.astype(np.int32)),
        bvh=bvh,
        wide=wide,
    )


def _sphere_device(centers, radii, transp, tex, bvh) -> SphereDeviceData:
    return SphereDeviceData(
        center=jnp.asarray(np.asarray(centers, np.float32)),
        radius=jnp.asarray(np.asarray(radii, np.float32)),
        transparency=jnp.asarray(np.asarray(transp, np.float32)),
        tex=jnp.asarray(np.asarray(tex, np.int32)), bvh=bvh)


def _merge_mesh_geometry(meshes_geo):
    """Concatenate N meshes' indexed geometry into one global index space.

    ``meshes_geo``: iterable of (positions, normals, uvs, face_p, face_n,
    face_t, face_tex) tuples. Returns one such tuple whose face arrays are
    offset into the concatenated vertex tables and whose triangle order is
    mesh-major — the same order ``_tri_attr_table`` packs attribute rows,
    so global triangle ids index both consistently.

    Multi-mesh: the reference walks one BVH per mesh and min-reduces in
    World.hit (15_module.py:838-848) — which here would run one traversal
    per mesh per bounce. Merging all triangles under ONE global BVH makes
    an N-mesh scene cost exactly one traversal per wavefront."""
    ps, ns, us = [], [], []
    fps, fns, fts, texs = [], [], [], []
    po = no = uo = 0
    for (p, n, u, fp, fn, ft, tex) in meshes_geo:
        ps.append(np.asarray(p, np.float32))
        ns.append(np.asarray(n, np.float32))
        us.append(np.asarray(u, np.float32))
        fps.append(np.asarray(fp, np.int64) + po)
        fns.append(np.asarray(fn, np.int64) + no)
        fts.append(np.asarray(ft, np.int64) + uo)
        texs.append(np.asarray(tex, np.int32))
        po += ps[-1].shape[0]
        no += ns[-1].shape[0]
        uo += us[-1].shape[0]
    return (np.concatenate(ps), np.concatenate(ns), np.concatenate(us),
            np.concatenate(fps), np.concatenate(fns), np.concatenate(fts),
            np.concatenate(texs))


def _build_mesh_devices(meshes_geo, mesh_max_depth, mesh_max_leaf,
                        merge: bool = True):
    """MeshDeviceData tuple for a list of mesh geometry tuples.

    ``merge=True`` (default) returns ONE merged device mesh for multi-mesh
    scenes (see _merge_mesh_geometry); ``merge=False`` keeps one device
    structure per mesh (reference-parity mode, used with the serialized
    per-mesh trees)."""
    if merge and len(meshes_geo) > 1:
        meshes_geo = [_merge_mesh_geometry(meshes_geo)]
    devices = []
    for (p, n, u, fp, fn, ft, tex) in meshes_geo:
        tri_p = np.asarray(p)[np.asarray(fp)]
        bvh = build_bvh(tri_p.min(axis=1), tri_p.max(axis=1),
                        centroid=tri_p.mean(axis=1),
                        max_depth=mesh_max_depth, max_leaf=mesh_max_leaf)
        devices.append(_mesh_device(p, n, u, fp, fn, ft, tex, bvh))
    return tuple(devices)


def _tri_attr_table(meshes: tuple) -> jnp.ndarray | None:
    """Pack every mesh's triangle attributes into one f32[sum(T), 32] row
    table (see LegacyWorldData.tri_attr)."""
    if not meshes:
        return None
    rows = []
    for m in meshes:
        t = np.asarray(m.tex, np.float32)[:, None]
        block = np.concatenate(
            [np.asarray(m.v0), np.asarray(m.v1), np.asarray(m.v2),
             np.asarray(m.n0), np.asarray(m.n1), np.asarray(m.n2),
             np.asarray(m.uv0), np.asarray(m.uv1), np.asarray(m.uv2),
             t], axis=1).astype(np.float32)
        rows.append(block)
    table = np.concatenate(rows, axis=0)
    pad = np.zeros((table.shape[0], 32 - table.shape[1]), np.float32)
    return jnp.asarray(np.concatenate([table, pad], axis=1))


def _content_size(configs, fallback=(8, 8)):
    """Tight atlas extent actually covered by packed rects (device memory
    saver — the reference always allocates the full 12288x2048 atlas)."""
    if not configs:
        return fallback
    from ..io.texture import _area_field

    w = max(_area_field(c["area"], "high")[0] for c in configs)
    h = max(_area_field(c["area"], "high")[1] for c in configs)
    return (max(int(w), 1), max(int(h), 1))


def _default_environment(tm: TextureManager):
    """14-era files carry no environment dump; synthesize a small builtin
    sky-gradient rect so escape radiance is well-defined."""
    if not tm.configs:
        tm.size = (64, 32)
        tm.configs = [{
            "file_path": "<builtin:sky>",
            "size": (64, 32), "id": 0,
            "area": {"low": (0, 0), "high": (64, 32)},
        }]


def _active_gradient_h(tm: TextureManager, environment, gradient_ids):
    """Rect height of the ACTIVE environment iff it holds the baked sky
    gradient (see build_environment_atlas), else None."""
    active = int(environment or 0)
    if active not in gradient_ids:
        return None
    for cfg in tm.configs:
        if int(cfg["id"]) == active:
            from ..io.texture import _area_field

            low = _area_field(cfg["area"], "low")
            high = _area_field(cfg["area"], "high")
            return int(high[1]) - int(low[1])
    return None


def _bvh_from_record(rec) -> FlatBVH:
    cut = np.asarray(rec["cut"], np.int32)
    sizes = cut[1:] - cut[:-1]
    return FlatBVH(
        left=jnp.asarray(rec["nodes"]["left"]),
        right=jnp.asarray(rec["nodes"]["right"]),
        low=jnp.asarray(rec["nodes"]["low"]),
        high=jnp.asarray(rec["nodes"]["high"]),
        data=jnp.asarray(rec["nodes"]["data"]),
        cut=jnp.asarray(cut),
        prim=jnp.arange(int(cut[-1]), dtype=jnp.int32),
        max_depth=int(rec["max_depth"]),
        max_leaf=int(sizes.max(initial=1)),
    )


class LegacyWorld:
    """Host-side scene builder mirroring 15_module World's API."""

    def __init__(self, texture_size=(2048 * 6, 2048),
                 environment_size=(2048, 2048)):
        self.meshes: list[MeshData] = []
        self.spheres: list[dict] = []
        self.environment: int | None = None
        self.textures = TextureManager(texture_size)
        self.environments = TextureManager(environment_size)
        self._device: LegacyWorldData | None = None
        self._bvh_records = None  # for save()

    def add_mesh(self, mesh: MeshData):
        self.meshes.append(mesh)
        self._device = None

    def add_sphere(self, center, radius, transparency=0, texture_id=0):
        self.spheres.append({
            "center": tuple(float(c) for c in center),
            "radius": float(radius),
            "transparency": int(transparency),
            "texture_id": int(texture_id),
        })
        self._device = None

    def set_environment(self, id):
        self.environment = int(id)

    # ------------------------------------------------------------- build --
    def build(self, mesh_max_depth=24, sphere_max_depth=12, max_leaf=8,
              mesh_max_leaf=8, path_map=None,
              merge_meshes: bool = True) -> LegacyWorldData:
        """Pack textures, build atlases and BVHs, upload device tables.

        ``merge_meshes`` (default True): multi-mesh scenes traverse ONE
        merged global BVH on device (see _merge_mesh_geometry) — one
        traversal per wavefront regardless of mesh count. Serialization keeps
        the reference's per-mesh trees either way. False = one device
        structure per mesh (the reference's World.hit composition,
        15_module.py:838-848; kept for parity testing)."""
        self.textures.build()
        _default_environment(self.environments)
        self.environments.build()
        atlas_np = build_texture_atlas(self.textures.configs,
                                       _content_size(self.textures.configs),
                                       path_map=path_map)
        env_np, env_grad_ids = build_environment_atlas(
            self.environments.configs,
            _content_size(self.environments.configs), path_map=path_map)

        merge = merge_meshes and len(self.meshes) > 1
        mesh_records = []
        mesh_devices = []
        for mesh in self.meshes:
            tri_p = mesh.positions[mesh.face_p]      # [T,3,3]
            plow = tri_p.min(axis=1)
            phigh = tri_p.max(axis=1)
            bvh = build_bvh(plow, phigh, centroid=tri_p.mean(axis=1),
                            max_depth=mesh_max_depth, max_leaf=mesh_max_leaf)
            # (mesh_max_depth default below keeps reference parity for
            # serialization; traversal quality comes from the wide collapse)
            if not merge:
                mesh_devices.append(_mesh_device(
                    mesh.positions, mesh.normals, mesh.uvs,
                    mesh.face_p, mesh.face_n, mesh.face_t, mesh.face_tex,
                    bvh))
            # leaf-ordered faces for reference-compatible serialization
            order = np.asarray(bvh.prim)
            mesh_records.append({
                "max_depth": mesh_max_depth,
                "nodes": {k: np.asarray(getattr(bvh, k)) for k in
                          ("left", "right", "low", "high", "data")},
                "cut": np.asarray(bvh.cut),
                "faces": {
                    "p": mesh.face_p[order], "n": mesh.face_n[order],
                    "t": mesh.face_t[order], "tex": mesh.face_tex[order],
                },
                "positions": mesh.positions, "normals": mesh.normals,
                "uvs": mesh.uvs,
            })
        if merge:
            mesh_devices = list(_build_mesh_devices(
                [(m.positions, m.normals, m.uvs, m.face_p, m.face_n,
                  m.face_t, m.face_tex) for m in self.meshes],
                mesh_max_depth, mesh_max_leaf, merge=True))

        sphere_record = None
        sphere_device = None
        if self.spheres:
            centers = np.array([s["center"] for s in self.spheres], np.float32)
            radii = np.array([s["radius"] for s in self.spheres], np.float32)
            transp = np.array([s["transparency"] for s in self.spheres], np.float32)
            tex = np.array([s["texture_id"] for s in self.spheres], np.int32)
            bvh = build_bvh(centers - radii[:, None], centers + radii[:, None],
                            centroid=centers, max_depth=sphere_max_depth,
                            max_leaf=max_leaf)
            order = np.asarray(bvh.prim)
            sphere_device = _sphere_device(centers, radii, transp, tex, bvh)
            sphere_record = {
                "max_depth": sphere_max_depth,
                "nodes": {k: np.asarray(getattr(bvh, k)) for k in
                          ("left", "right", "low", "high", "data")},
                "cut": np.asarray(bvh.cut),
                "spheres": {
                    "center": centers[order], "radius": radii[order],
                    "transparency": transp[order].astype(np.int32),
                    "texture_id": tex[order],
                },
            }

        tex_low, tex_high = make_info_arrays(self.textures.configs)
        env_low, env_high = make_info_arrays(self.environments.configs)
        self._device = LegacyWorldData(
            meshes=tuple(mesh_devices),
            spheres=sphere_device,
            atlas=pack_strips(atlas_np, tex_low, tex_high, texels=16,
                              dtype=jnp.bfloat16),
            envs=pack_strips(env_np, env_low, env_high, texels=42),
            env_id=jnp.int32(self.environment or 0),
            env_gradient_h=_active_gradient_h(self.environments,
                                              self.environment, env_grad_ids),
            tri_attr=_tri_attr_table(tuple(mesh_devices)),
        )
        self._bvh_records = (mesh_records, sphere_record)
        return self._device

    def device(self) -> LegacyWorldData:
        if self._device is None:
            raise RuntimeError("call build() or load() first")
        return self._device

    # --------------------------------------------------------------- I/O --
    def save(self, filename):
        if self._bvh_records is None:
            raise RuntimeError("build() before save()")
        mesh_records, sphere_record = self._bvh_records
        serialize.save_world_npy(
            filename,
            meshes_bvhs=mesh_records,
            spheres_bvh=sphere_record,
            environment=self.environment,
            textures=self.textures.dump(),
            environments=self.environments.dump(),
        )

    def load(self, filename, path_map=None,
             rebuild_bvh: bool = True,
             textures_from_obj: str | None = None,
             merge_meshes: bool = True) -> LegacyWorldData:
        """Load a .world.npy (either schema era).

        ``rebuild_bvh=True`` (default) rebuilds the acceleration structures
        from the serialized geometry with our build settings (depth 24,
        max_leaf 4): the reference's depth-16-capped trees contain leaves of
        up to ~60 primitives, which multiply the lockstep traversal's
        per-iteration unroll cost ~15x. ``rebuild_bvh=False`` uses the
        file's trees exactly as stored (parity/debugging).

        ``textures_from_obj``: 14-era files (demo/Ganyu/Zhongli/
        Yoimiya_ShapeChange) carry no texture configs — the reference loads
        textures separately from the companion OBJ's materials into fixed
        2048-wide atlas slots (14_mesh.py:994-999). Pass the OBJ path to
        reproduce that; the file's face texture_ids index those slots.
        """
        data = serialize.load_world_npy(filename)
        self.environment = data["environment"]

        if data["textures"] is not None:
            self.textures.load(data["textures"])
        elif textures_from_obj is not None:
            from ..io.obj import load_obj

            obj_path = (path_map(textures_from_obj) if path_map
                        else textures_from_obj)
            mats = load_obj(obj_path, texture_start_id=0).textures
            configs = []
            for i, m in enumerate(mats):
                configs.append({
                    "file_path": m["file_path"],
                    "size": (2048, 2048), "id": int(m["id"]),
                    "area": {"low": (i * 2048, 0),
                             "high": ((i + 1) * 2048, 2048)},
                })
            self.textures.size = (2048 * max(len(configs), 1), 2048)
            self.textures.configs = configs
        if data["environments"] is not None:
            self.environments.load(data["environments"])
        _default_environment(self.environments)
        atlas_np = build_texture_atlas(self.textures.configs,
                                       _content_size(self.textures.configs),
                                       path_map=path_map)
        env_np, env_grad_ids = build_environment_atlas(
            self.environments.configs,
            _content_size(self.environments.configs), path_map=path_map)

        if rebuild_bvh:
            # Multi-mesh files merge into ONE global BVH by default
            # (merge_meshes; see _merge_mesh_geometry).
            mesh_devices = list(_build_mesh_devices(
                [(rec["positions"], rec["normals"], rec["uvs"],
                  rec["faces"]["p"], rec["faces"]["n"], rec["faces"]["t"],
                  rec["faces"]["tex"]) for rec in data["meshes_bvhs"]],
                24, 8, merge=merge_meshes))
        else:
            mesh_devices = []
            for rec in data["meshes_bvhs"]:
                f = rec["faces"]
                bvh = _bvh_from_record(rec)
                mesh_devices.append(_mesh_device(
                    rec["positions"], rec["normals"], rec["uvs"],
                    f["p"], f["n"], f["t"], f["tex"], bvh))

        sphere_device = None
        if data["spheres_bvh"] is not None:
            rec = data["spheres_bvh"]
            s = rec["spheres"]
            if rebuild_bvh:
                c = np.asarray(s["center"], np.float32)
                r = np.asarray(s["radius"], np.float32)[:, None]
                sbvh = build_bvh(c - r, c + r, centroid=c, max_depth=12,
                                 max_leaf=4)
            else:
                sbvh = _bvh_from_record(rec)
            sphere_device = _sphere_device(
                s["center"], s["radius"],
                np.asarray(s["transparency"], np.float32),
                s["texture_id"], sbvh)

        tex_low, tex_high = make_info_arrays(self.textures.configs)
        env_low, env_high = make_info_arrays(self.environments.configs)
        self._device = LegacyWorldData(
            meshes=tuple(mesh_devices),
            spheres=sphere_device,
            atlas=pack_strips(atlas_np, tex_low, tex_high, texels=16,
                              dtype=jnp.bfloat16),
            envs=pack_strips(env_np, env_low, env_high, texels=42),
            env_id=jnp.int32(self.environment or 0),
            env_gradient_h=_active_gradient_h(self.environments,
                                              self.environment, env_grad_ids),
            tri_attr=_tri_attr_table(tuple(mesh_devices)),
        )
        return self._device


# --------------------------------------------------------------- tracing --

def _attrs_block(world: LegacyWorldData, point, pidx, src_best, hit_mask):
    """Attribute fetch + material tap for M lanes (any static M).

    Deferred shading: one attribute gather + ONE atlas tap for the whole
    batch, regardless of structure/mesh count (the reference taps per
    structure, per thread, 15_module.py:864-953). Returns
    (normal, uv, albedo, roughness, metallic, transparency), each [M,...];
    miss lanes get the defaults the guards below produce.
    """
    m_lanes = hit_mask.shape[0]
    normal = jnp.zeros((m_lanes, 3), jnp.float32).at[:, 2].set(1.0)
    uv = jnp.zeros((m_lanes, 2), jnp.float32)
    transparency = jnp.zeros((m_lanes,), jnp.float32)

    atlas = world.atlas
    is_mesh = src_best >= 1
    u_tap = jnp.full((m_lanes,), 0.5, jnp.float32)
    v_tap = jnp.full((m_lanes,), 0.5, jnp.float32)
    tex_tap = jnp.zeros((m_lanes,), jnp.int32)

    # --- sphere attributes (4 small gathers; spheres also need the normal-
    # map tangent frame, 15_module.py:874-895) ---
    sp_frame = None
    if world.spheres is not None:
        s = world.spheres
        m = src_best == 0
        c = jnp.take(s.center, pidx, axis=0)
        r = jnp.take(s.radius, pidx, axis=0)
        nv = (point - c) / jnp.maximum(r, 1e-20)[:, None]
        rr = jnp.sqrt(jnp.maximum(nv[:, 0] ** 2 + nv[:, 2] ** 2, 1e-20))
        tang = jnp.stack([nv[:, 2] / rr, jnp.zeros_like(rr), -nv[:, 0] / rr], -1)
        bitang = jnp.stack([nv[:, 0] * nv[:, 1], -rr, nv[:, 2] * nv[:, 1]], -1)
        phi = jnp.arcsin(jnp.clip(nv[:, 1], -1.0, 1.0))
        theta = jnp.arctan2(-nv[:, 0], -nv[:, 2])
        su = (theta / jnp.pi + 1.0) / 2.0
        sv = phi / jnp.pi + 0.5
        sp_frame = (m, nv, tang, bitang)
        uv = jnp.where(m[:, None], jnp.stack([su, sv], -1), uv)
        u_tap = jnp.where(m, 2.0 * su, u_tap)
        v_tap = jnp.where(m, sv, v_tap)
        tex_tap = jnp.where(m, jnp.take(s.tex, pidx, axis=0), tex_tap)
        transparency = jnp.where(m, jnp.take(s.transparency, pidx, axis=0),
                                 transparency)

    # --- mesh attributes: one packed-row gather for ALL meshes ---
    if world.meshes:
        offsets = np.cumsum(
            [0] + [int(m_.tex.shape[0]) for m_ in world.meshes])[:-1]
        gidx = pidx
        if len(world.meshes) > 1:
            off = jnp.zeros((m_lanes,), jnp.int32)
            for k in range(1, len(world.meshes)):
                off = jnp.where(src_best == 1 + k,
                                jnp.int32(int(offsets[k])), off)
            gidx = pidx + off
        row = jnp.take(world.tri_attr, jnp.where(is_mesh, gidx, 0), axis=0)
        # cross-ratio barycentrics (triangle_barycentrics' form,
        # 15_module.py:923-931) expressed component-wise on 1-D [M] vectors
        # after one gather-fused transpose
        ct = row.T                                       # [32, M]
        p1x, p1y, p1z = ct[0], ct[1], ct[2]
        p2x, p2y, p2z = ct[3], ct[4], ct[5]
        p3x, p3y, p3z = ct[6], ct[7], ct[8]

        def _cross1(ax, ay, az, bx, by, bz):
            return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx

        nx, ny, nz = _cross1(p2x - p1x, p2y - p1y, p2z - p1z,
                             p3x - p1x, p3y - p1y, p3z - p1z)
        ninv = 1.0 / jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-20)
        nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
        px, py, pz = point[:, 0], point[:, 1], point[:, 2]
        ex, ey, ez = p3x - p2x, p3y - p2y, p3z - p2z
        cx, cy, cz = _cross1(ex, ey, ez, px - p2x, py - p2y, pz - p2z)
        dx, dy, dz = _cross1(ex, ey, ez, p1x - p2x, p1y - p2y, p1z - p2z)
        w1 = (cx * nx + cy * ny + cz * nz) / (dx * nx + dy * ny + dz * nz)
        ex, ey, ez = p1x - p3x, p1y - p3y, p1z - p3z
        cx, cy, cz = _cross1(ex, ey, ez, px - p3x, py - p3y, pz - p3z)
        dx, dy, dz = _cross1(ex, ey, ez, p2x - p3x, p2y - p3y, p2z - p3z)
        w2 = (cx * nx + cy * ny + cz * nz) / (dx * nx + dy * ny + dz * nz)
        w3 = 1.0 - w1 - w2
        smx = w1 * ct[9] + w2 * ct[12] + w3 * ct[15]
        smy = w1 * ct[10] + w2 * ct[13] + w3 * ct[16]
        smz = w1 * ct[11] + w2 * ct[14] + w3 * ct[17]
        sinv = 1.0 / jnp.maximum(
            jnp.sqrt(smx * smx + smy * smy + smz * smz), 1e-20)
        su = w1 * ct[18] + w2 * ct[20] + w3 * ct[22]
        sv = w1 * ct[19] + w2 * ct[21] + w3 * ct[23]
        m_tex = ct[24].astype(jnp.int32)
        mm = is_mesh[:, None]
        # triangle normal mapping is computed but disabled in the reference
        # (15_module.py:945) — smooth vertex normal wins
        normal = jnp.where(
            mm, jnp.stack([smx * sinv, smy * sinv, smz * sinv], -1), normal)
        uv = jnp.where(mm, jnp.stack([su, sv], -1), uv)
        u_tap = jnp.where(is_mesh, su, u_tap)
        v_tap = jnp.where(is_mesh, sv, v_tap)
        tex_tap = jnp.where(is_mesh, jnp.maximum(m_tex, 0), tex_tap)

    # --- the single material tap (strip-packed: one pair-row gather) ---
    tap = sample_bilinear_strips(atlas, tex_tap, u_tap, v_tap, channels=8)
    albedo = jnp.where(hit_mask[:, None], tap[:, 0:3], 0.0)
    roughness = jnp.where(hit_mask, tap[:, 6], 0.0)
    metallic = jnp.where(hit_mask, tap[:, 7], 0.0)

    if sp_frame is not None:
        m, nv, tang, bitang = sp_frame
        nc = tap[:, 3:6]
        mapped = nc[:, 0:1] * tang + nc[:, 1:2] * bitang + nc[:, 2:3] * nv
        mapped = mapped / jnp.maximum(
            jnp.sqrt(jnp.sum(mapped * mapped, -1, keepdims=True)), 1e-20)
        normal = jnp.where(m[:, None], mapped, normal)

    return normal, uv, albedo, roughness, metallic, transparency


def _attrs_switch(world: LegacyWorldData, point, pidx, src_best, hit_mask,
                  count):
    """_attrs_block on the narrowest static prefix covering ``count`` lanes.

    Callers must arrange that all lanes needing real attributes sit in the
    first ``count`` rows (hit-compacted order in _shade_attrs and
    trace_shade_compact). Prefix widths are static
    {n/16, n/4, n}; ``lax.switch`` picks the narrowest that fits, so the
    row-count-bound gathers (tri-attr row + atlas pair row) scale with the
    prefix, and a close-up view falls back to the exact full-width path.
    """
    from jax import lax

    n = hit_mask.shape[0]

    def _r256(v):
        return -(-v // 256) * 256

    prefixes = sorted({w for w in (_r256(n // 16), _r256(n // 4))
                       if 0 < w < n})
    if not prefixes:
        return _attrs_block(world, point, pidx, src_best, hit_mask)

    def make_branch(kw: int | None):
        def branch(spoint, spidx, ssrc, shit):
            if kw is None:
                return _attrs_block(world, spoint, spidx, ssrc, shit)
            outs = _attrs_block(world, spoint[:kw], spidx[:kw], ssrc[:kw],
                                shit[:kw])
            pad_nrm = jnp.zeros((n - kw, 3), jnp.float32).at[:, 2].set(1.0)
            pads = (pad_nrm, jnp.zeros((n - kw, 2), jnp.float32),
                    jnp.zeros((n - kw, 3), jnp.float32),
                    jnp.zeros((n - kw,), jnp.float32),
                    jnp.zeros((n - kw,), jnp.float32),
                    jnp.zeros((n - kw,), jnp.float32))
            return tuple(jnp.concatenate([o, p], axis=0)
                         for o, p in zip(outs, pads))
        return branch

    branches = [make_branch(kw) for kw in prefixes] + [make_branch(None)]
    bindex = sum((count > jnp.int32(kw)).astype(jnp.int32) for kw in prefixes)
    return lax.switch(bindex, branches, point, pidx, src_best, hit_mask)


def _shade_attrs(world: LegacyWorldData, point, pidx, src_best, hit_mask):
    """_attrs_block, compacted to the lanes that actually hit.

    The block's gathers (tri-attr row + atlas pair row) are row-COUNT bound
    — collapsing miss lanes' indices to row 0 does not help; only gathering
    fewer rows does. Wavefront hit fractions are often small (misses only
    ever need the defaults), so: stable-partition hits to the front by
    carrying the lane payload THROUGH ``lax.sort``, run the block on the
    smallest static prefix that covers the hit count, and restore lane
    order with a second sort keyed on the carried index. Tap+gather cost
    then scales with hits, for ~2 extra [N]-row sorts.

    Prefix widths are static {n/16, n/4, n}; ``lax.switch`` picks the
    narrowest that fits, so a close-up view (high hit fraction) falls back
    to the exact full-width path.
    """
    import jax
    from jax import lax

    n = hit_mask.shape[0]

    def _r256(v):
        return -(-v // 256) * 256

    prefixes = sorted({w for w in (_r256(n // 16), _r256(n // 4))
                       if 0 < w < n})
    if n < 4096 or not prefixes:
        return _attrs_block(world, point, pidx, src_best, hit_mask)

    key = (~hit_mask).astype(jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    (_, px, py, pz, spidx, ssrc, sidx) = lax.sort(
        (key, point[:, 0], point[:, 1], point[:, 2], pidx, src_best, idx),
        num_keys=1)
    spoint = jnp.stack([px, py, pz], axis=-1)
    count = jnp.sum(hit_mask.astype(jnp.int32))
    shit = idx < count   # sorted order: exactly the first `count` lanes hit

    nrm, suv, alb, rgh, met, tra = _attrs_switch(
        world, spoint, spidx, ssrc, shit, count)

    # restore lane order: sort by the carried original index (a permutation,
    # exact). 12 operands, one pass.
    (_, n0, n1, n2, u0, u1, a0, a1, a2, rgho, meto, trao) = lax.sort(
        (sidx, nrm[:, 0], nrm[:, 1], nrm[:, 2], suv[:, 0], suv[:, 1],
         alb[:, 0], alb[:, 1], alb[:, 2], rgh, met, tra), num_keys=1)
    return (jnp.stack([n0, n1, n2], -1), jnp.stack([u0, u1], -1),
            jnp.stack([a0, a1, a2], -1), rgho, meto, trao)


def _assemble_hits(world: LegacyWorldData, rays: Rays, t_best, prim_best,
                   hit_mask, normal, uv, albedo, roughness, metallic,
                   transparency) -> Hits:
    """Shared hit-record tail: legacy constants + back-face handling
    (propagate_once, 15_module.py:985-988): flip normal, invert ior, zero
    absorptivity."""
    t_safe = jnp.where(hit_mask, t_best, 0.0)
    point = rays.ro + t_safe[:, None] * rays.rd
    return _assemble_hits_at(rays.rd, point, t_best, prim_best, hit_mask,
                             normal, uv, albedo, roughness, metallic,
                             transparency)


def _assemble_hits_at(rd, point, t_best, prim_best, hit_mask, normal, uv,
                      albedo, roughness, metallic, transparency) -> Hits:
    """_assemble_hits for callers that already hold hit points (compacted
    orders where the ray origin was not carried)."""
    n = rd.shape[0]
    ior = jnp.full((n,), LEGACY_IOR, jnp.float32)
    absorptivity = jnp.full((n,), LEGACY_ABSORPTIVITY, jnp.float32)
    backface = (jnp.sum(rd * normal, axis=-1) > 0.0) & hit_mask
    normal = jnp.where(backface[:, None], -normal, normal)
    ior = jnp.where(backface, 1.0 / ior, ior)
    absorptivity = jnp.where(backface, 0.0, absorptivity)
    mat = Materials(albedo=albedo, roughness=roughness, metallic=metallic,
                    ior=ior, transparency=transparency,
                    absorptivity=absorptivity)
    return Hits(t=t_best, point=point, normal=normal, uv=uv,
                obj=jnp.where(hit_mask, prim_best, -1), hit=hit_mask,
                material=mat)


def trace_legacy(world: LegacyWorldData, rays: Rays, eps: float = EPSILON):
    """Traversal-only nearest hit across sphere BVH + all mesh BVHs.

    Returns ``(t_best f32[N] — +inf on miss, prim_best i32[N] — -1 on miss,
    src_best i32[N] — -1 none / 0 spheres / 1+k mesh k)``. No attribute
    gathers or atlas taps happen here; callers that defer shading to a
    compacted survivor set (integrator/hybrid.py) pair this with
    ``shade_from_trace`` at the narrow width. ``hit_legacy`` composes both
    at full width (reference propagate_once hit semantics,
    15_module.py:838-848). The same XLA traversals run on every platform:
    the binary sphere BVH (accel/traverse.py) and the 8-wide mesh BVH
    (accel/wide.py)."""
    n = rays.count
    ro, rd = rays.ro, rays.rd

    t_best = jnp.full((n,), jnp.inf, jnp.float32)
    prim_best = jnp.full((n,), -1, jnp.int32)
    src_best = jnp.full((n,), -1, jnp.int32)  # -1 none, 0 spheres, 1+k mesh k

    if world.spheres is not None:
        s = world.spheres
        lt = make_sphere_leaf_test(s.center, s.radius, s.transparency,
                                   eps=eps)
        t, p = traverse(s.bvh, ro, rd, lt, eps=eps)
        better = t < t_best
        t_best = jnp.where(better, t, t_best)
        prim_best = jnp.where(better, p, prim_best)
        src_best = jnp.where(better, 0, src_best)

    for k, mesh in enumerate(world.meshes):
        # seed best-t with prior structures' results: later BVHs prune
        # subtrees already occluded by earlier geometry
        lt = make_triangle_leaf_test(mesh.v0, mesh.v1, mesh.v2, eps=eps)
        if mesh.wide is not None:
            t, p = traverse_wide(mesh.wide, ro, rd, lt, eps=eps, t_init=t_best)
        else:
            t, p = traverse(mesh.bvh, ro, rd, lt, eps=eps, t_init=t_best)
        better = (t < t_best) & (p >= 0)
        t_best = jnp.where(better, t, t_best)
        prim_best = jnp.where(better, p, prim_best)
        src_best = jnp.where(better, 1 + k, src_best)

    return t_best, prim_best, src_best


def shade_from_trace(world: LegacyWorldData, rays: Rays, t_best, prim_best,
                     src_best, count=None) -> Hits:
    """Attribute shading + hit assembly for ``trace_legacy`` results.

    Materials are sampled from the texture atlas (15_module.py:864-953
    semantics: triangle normal mapping disabled, sphere normal mapping
    enabled, fixed ior/absorptivity) and the back-face flip with ior
    inversion + absorptivity zeroing from propagate_once (:985-988) is
    applied. ``count`` (optional traced i32): callers that already hold
    hit lanes as a PREFIX of the first ``count`` rows (compacted survivor
    batches) pass it so the row-count-bound gathers run on the narrowest
    static prefix; default applies _shade_attrs' own hit compaction."""
    hit_mask = jnp.isfinite(t_best)
    t_safe = jnp.where(hit_mask, t_best, 0.0)
    point = rays.ro + t_safe[:, None] * rays.rd
    pidx = jnp.maximum(prim_best, 0)

    if count is not None:
        normal, uv, albedo, roughness, metallic, transparency = \
            _attrs_switch(world, point, pidx, src_best, hit_mask, count)
    else:
        normal, uv, albedo, roughness, metallic, transparency = _shade_attrs(
            world, point, pidx, src_best, hit_mask)

    return _assemble_hits(world, rays, t_best, prim_best, hit_mask, normal,
                          uv, albedo, roughness, metallic, transparency)


def hit_legacy(world: LegacyWorldData, rays: Rays,
               eps: float = EPSILON) -> Hits:
    """Nearest hit across sphere BVH + all mesh BVHs, with materials sampled
    from the texture atlas (15_module.py:838-848 + 864-953 semantics,
    including the reference's choices: triangle normal mapping disabled,
    sphere normal mapping enabled, fixed ior/absorptivity, and the
    back-face flip with absorptivity zeroing from propagate_once :985-988)."""
    t_best, prim_best, src_best = trace_legacy(world, rays, eps=eps)
    return shade_from_trace(world, rays, t_best, prim_best, src_best)


def trace_shade_compact(world: LegacyWorldData, ro, rd, alive, payload,
                        eps: float = EPSILON):
    """Fused bounce step for pool integrators whose lane order is FREE:
    traverse, hit-compact, shade attributes on the exact hit prefix — and
    never restore lane order.

    ``hit_legacy`` must return lanes in caller order. A persistent/hybrid
    pool does not care about its own lane order (RNG streams key on the
    carried work-item id, radiance accumulation on the derived pixel id),
    so this entry instead carries the caller's whole per-lane state
    (``payload``: tuple of [N] columns) THROUGH one hit-compaction sort,
    returning everything permuted-and-compacted: rows ``[0, nhits)`` are
    the hits, the suffix holds misses and inactive lanes. Downstream passes
    get two structural wins: attrs run on the exact hit count, and the
    pool's alive set becomes a near-prefix so cascade narrowing is a SLICE
    instead of a multi-operand sort.

    Returns ``(hits, rd_c, payload_c, nhits)``: ``hits`` a Hits struct in
    compacted order (reference semantics incl. the back-face flip,
    15_module.py:985-988), ``rd_c`` the incident directions, ``payload_c``
    the caller columns, ``nhits`` i32.
    """
    import jax

    n = ro.shape[0]
    payload = tuple(payload)
    rays = Rays(ro=ro, rd=rd, throughput=jnp.ones_like(ro), alive=alive)
    t_s, prim_s, src_s = trace_legacy(world, rays, eps=eps)
    prim_s = jnp.where(alive, prim_s, -1)
    t_s = jnp.where(prim_s >= 0, t_s, jnp.inf)

    hit_s = prim_s >= 0
    t_safe = jnp.where(hit_s, t_s, 0.0)
    point_s = ro + t_safe[:, None] * rd
    nhits = jnp.sum(hit_s.astype(jnp.int32))
    ops = jax.lax.sort(
        ((~hit_s).astype(jnp.int32), t_s, prim_s, src_s,
         point_s[:, 0], point_s[:, 1], point_s[:, 2],
         rd[:, 0], rd[:, 1], rd[:, 2]) + payload, num_keys=1)
    (_, t_c, prim_c, src_c, px, py, pz, rdx, rdy, rdz) = ops[:10]
    payload_c = ops[10:]
    point_c = jnp.stack([px, py, pz], -1)
    rd_c = jnp.stack([rdx, rdy, rdz], -1)
    hit_c = jnp.arange(n, dtype=jnp.int32) < nhits
    nrm, suv, alb, rgh, met, tra = _attrs_switch(
        world, point_c, jnp.maximum(prim_c, 0), src_c, hit_c, nhits)
    hits = _assemble_hits_at(rd_c, point_c, jnp.where(hit_c, t_c, jnp.inf),
                             prim_c, hit_c, nrm, suv, alb, rgh, met, tra)
    return hits, rd_c, payload_c, nhits


def environment_color(envs: StripAtlas, env_id, rd, mask=None,
                      gradient_h: int | None = None):
    """Equirect IBL lookup (15_module.py:970-977).

    ``mask`` (bool[N], optional): lanes whose result is unused — their tap
    coordinates collapse to one texel so the latency-bound random gather
    only pays for lanes that actually escaped this pass.

    ``gradient_h`` (static, from LegacyWorldData.env_gradient_h): when the
    active environment is the baked sky-gradient fallback, evaluate the tap
    in closed form — the rect is constant along u and linear in v, so the
    bilinear tap reduces to the same two-texel v-blend computed directly
    from ``rd`` (zero gathers instead of two row gathers per lane).
    """
    phi = jnp.arcsin(jnp.clip(rd[:, 1], -1.0, 1.0))
    v = phi / jnp.pi + 0.5
    if gradient_h is not None:
        # The texel blend wb*grad(b) + (1-wb)*grad(b+1) of a LINEAR ramp
        # collapses algebraically: with b = trunc(vv) and wb = b+1-vv, the
        # interior (and the trunc'd vv<0 edge, which extrapolates) reduces
        # to exactly vv/denom; only the v-wrap row b = h-1 blends back
        # toward the bottom texel, giving h-vv. One select instead of the
        # int-cast/mod/two-grad pipeline.
        h = int(gradient_h)
        vv = v * jnp.float32(h) - 0.5
        denom = float(max(h - 1, 1))
        f = jnp.where(vv < h - 1, vv / denom, h - vv)[:, None]
        top = jnp.asarray([0.5, 0.7, 1.0], jnp.float32)
        bottom = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)
        return bottom[None] + (top - bottom)[None] * f
    theta = jnp.arctan2(-rd[:, 0], -rd[:, 2])
    u = (theta / jnp.pi + 1.0) / 2.0
    if mask is not None:
        u = jnp.where(mask, u, 0.5)
        v = jnp.where(mask, v, 0.5)
    ids = jnp.broadcast_to(jnp.asarray(env_id, jnp.int32), u.shape)
    return sample_bilinear_strips(envs, ids, u, v, channels=3)
