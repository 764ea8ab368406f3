"""Cameras: yaw/pitch/roll rotation, pinhole and thin-lens ray generation.

Mirrors the reference camera line
(/root/reference/taichi_pathtracer/{2_camera_and_ray,5_anti_aliasing,9_dof}/camera.py):

- ``model='center'``  — stages 2-4: rays through pixel centers, no jitter,
  offsets ``i/(W-1) - 0.5``;
- ``model='thinlens'`` — stages 5-10: sub-pixel jitter ``(i+u)/W - 0.5``,
  thin-lens depth of field (focal plane at ``focal_length``, aperture disk
  sampling). Stages 5-8 are the special case focal=1, aperture=0.

Host-side ``Camera`` keeps python floats and mirrors the reference's API
(set_position / set_direction / set_fov / set_len / look_at, plus the legacy
free-fly moves from 12_free_view.py:144-240); ``params()`` exports a pytree
so jitted renderers re-trace nothing when the camera moves.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
from jax import lax

from ..core import rng
from ..core.pytree import pytree_dataclass
from ..core.types import Rays
from ..bsdf import sampling as sp


@pytree_dataclass
class CameraParams:
    position: jnp.ndarray      # f32[3]
    yaw: jnp.ndarray           # f32 degrees
    pitch: jnp.ndarray         # f32 degrees
    roll: jnp.ndarray          # f32 degrees
    fov: jnp.ndarray           # f32 degrees (horizontal)
    focal_length: jnp.ndarray  # f32
    aperture: jnp.ndarray      # f32
    # fov degrees → half-angle factor. The modern camera treats fov as the
    # full horizontal angle (view_width = 2·tan(fov/2), 9_dof/camera.py:81);
    # the legacy camera treats it as the HALF angle (view_width =
    # 2·tan(fov), 12_free_view.py:216) — so 'fov 30' is ~2x wider there.
    fov_scale: jnp.ndarray = None  # f32: 0.5 modern, 1.0 legacy


def rotation_matrix(yaw_deg, pitch_deg, roll_deg):
    """Yaw (about +y), then pitch (about +x), then roll (about +z) — the
    composition order of 9_dof/camera.py:7-29. Returns ``f32[3,3]``."""
    y = jnp.deg2rad(yaw_deg)
    p = jnp.deg2rad(pitch_deg)
    r = jnp.deg2rad(roll_deg)
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp_ = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(r), jnp.sin(r)
    yaw_m = jnp.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    pitch_m = jnp.array([[1.0, 0.0, 0.0], [0.0, cp, -sp_], [0.0, sp_, cp]])
    roll_m = jnp.array([[cr, -sr, 0.0], [sr, cr, 0.0], [0.0, 0.0, 1.0]])
    # HIGHEST: a GPU may run default-precision f32 products in TF32, which
    # would shift every ray by about a pixel
    hi = lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(yaw_m, pitch_m, precision=hi), roll_m,
                      precision=hi).astype(jnp.float32)


def pixel_grid(resolution):
    """Flat pixel coordinates; index p maps to (i, j) = (p // H, p % H),
    matching the reference's (W, H) field layout."""
    w, h = resolution
    return jnp.arange(w * h, dtype=jnp.uint32)


def generate_rays_for_pixels(params: CameraParams, resolution, pixel_ids,
                             seed, sample, model: str = "thinlens") -> Rays:
    """Emit one primary ray for each absolute pixel id in ``pixel_ids``.

    RNG is keyed on the *absolute* pixel id, so generating rays for a sharded
    chunk of the pixel grid yields bit-identical rays to the single-device
    path — the foundation of reshard-invariant multi-chip rendering.
    Pixel ids >= W*H (tile padding) produce valid dummy rays.
    """
    w, h = resolution
    n = pixel_ids.shape[0]
    pix = pixel_ids.astype(jnp.uint32)
    fi = (pix // jnp.uint32(h)).astype(jnp.float32)
    fj = (pix % jnp.uint32(h)).astype(jnp.float32)

    trans = rotation_matrix(params.yaw, params.pitch, params.roll)
    fov_scale = params.fov_scale if params.fov_scale is not None else 0.5
    view_width = 2.0 * jnp.tan(jnp.deg2rad(params.fov) * fov_scale)
    view_height = view_width * (h / w)
    # the basis vectors are the columns of trans (exact; no matrix product)
    direction = -trans[:, 2]
    width_axis = trans[:, 0]
    height_axis = trans[:, 1]

    if model == "center":
        du = (fi / (w - 1) - 0.5) * view_width
        dv = (fj / (h - 1) - 0.5) * view_height
        rd = sp.normalize(
            direction[None, :] + du[:, None] * width_axis[None, :]
            + dv[:, None] * height_axis[None, :]
        )
        ro = jnp.broadcast_to(params.position[None, :], (n, 3))
    elif model == "jitter":
        # Jittered pinhole — the legacy line's camera (12_free_view.py:
        # 216-240 has no lens). BIT-identical to 'thinlens' with
        # aperture=0, focal_length=1 (origin is exactly 0 there and the
        # same u0/u1 counters are drawn), but skips the second RNG hash
        # and the disk sample — regen runs every persistent pass, so this
        # is on the mesh bench's hot path.
        b = rng.base(rng.stream(seed, sample, 0, rng.STREAM_CAMERA), pix)
        u0, u1 = rng.uniform2(b, 0)
        du = ((fi + u0) / w - 0.5) * view_width
        dv = ((fj + u1) / h - 0.5) * view_height
        rd = sp.normalize(
            direction[None, :] + du[:, None] * width_axis[None, :]
            + dv[:, None] * height_axis[None, :]
        )
        ro = jnp.broadcast_to(params.position[None, :], (n, 3))
    elif model == "thinlens":
        b = rng.base(rng.stream(seed, sample, 0, rng.STREAM_CAMERA), pix)
        u0, u1 = rng.uniform2(b, 0)
        u2, u3 = rng.uniform2(b, 2)
        du = ((fi + u0) / w - 0.5) * view_width
        dv = ((fj + u1) / h - 0.5) * view_height
        target = params.focal_length * (
            direction[None, :] + du[:, None] * width_axis[None, :]
            + dv[:, None] * height_axis[None, :]
        )
        disk = sp.sample_in_disk(u2, u3)
        origin = (params.aperture * 0.5) * (
            disk[:, 0:1] * width_axis[None, :] + disk[:, 1:2] * height_axis[None, :]
        )
        ro = params.position[None, :] + origin
        rd = sp.normalize(target - origin)
    else:
        raise ValueError(f"unknown camera model: {model!r}")

    return Rays(
        ro=ro,
        rd=rd,
        throughput=jnp.ones((n, 3), jnp.float32),
        alive=jnp.ones((n,), bool),
    )


def generate_rays(params: CameraParams, resolution, seed, sample,
                  model: str = "thinlens") -> Rays:
    """Emit one jittered primary ray per pixel as a flat wavefront [W*H]."""
    return generate_rays_for_pixels(
        params, resolution, pixel_grid(resolution), seed, sample, model=model
    )


class Camera:
    """Host camera state mirroring the reference's Camera class."""

    FOV_SCALE = 0.5   # full-angle fov (modern line)

    def __init__(self, resolution, fov=60.0, focal_length=1.0, aperture=0.0):
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self.fov = float(fov)
        self.focal_length = float(focal_length)
        self.aperture = float(aperture)
        self.position = (0.0, 0.0, 0.0)
        self.yaw = 0.0
        self.pitch = 0.0
        self.roll = 0.0

    # -- reference API (9_dof/camera.py:49-69) --
    def set_position(self, position):
        self.position = tuple(float(c) for c in position)

    def set_direction(self, yaw, pitch, roll=0.0):
        self.yaw, self.pitch, self.roll = float(yaw), float(pitch), float(roll)

    def set_fov(self, fov):
        self.fov = float(fov)

    def set_len(self, focal_length=1.0, aperture=0.0):
        self.focal_length = float(focal_length)
        self.aperture = float(aperture)

    def look_at(self, target, roll=0.0):
        dx = target[0] - self.position[0]
        dy = target[1] - self.position[1]
        dz = target[2] - self.position[2]
        norm = math.sqrt(dx * dx + dy * dy + dz * dz)
        dx, dy, dz = dx / norm, dy / norm, dz / norm
        self.yaw = math.degrees(math.atan2(-dx, -dz))
        self.pitch = math.degrees(math.asin(dy))
        self.roll = float(roll)

    # -- legacy free-fly controls (12_free_view.py:197-240) --
    def _axes(self):
        y, p = math.radians(self.yaw), math.radians(self.pitch)
        front = (-math.sin(y) * math.cos(p), math.sin(p), -math.cos(y) * math.cos(p))
        right = (math.cos(y), 0.0, -math.sin(y))
        up = (0.0, 1.0, 0.0)
        return front, right, up

    def _move(self, axis, dist):
        self.position = tuple(p + dist * a for p, a in zip(self.position, axis))

    def move_front(self, dist):
        self._move(self._axes()[0], dist)

    def move_right(self, dist):
        self._move(self._axes()[1], dist)

    def move_up(self, dist):
        self._move(self._axes()[2], dist)

    def rotate(self, dyaw, dpitch):
        self.yaw = (self.yaw + dyaw) % 360.0
        self.pitch = max(-89.0, min(89.0, self.pitch + dpitch))

    # -- export for jitted renderers --
    def params(self) -> CameraParams:
        f32 = lambda v: jnp.asarray(v, jnp.float32)
        return CameraParams(
            position=f32(self.position),
            yaw=f32(self.yaw),
            pitch=f32(self.pitch),
            roll=f32(self.roll),
            fov=f32(self.fov),
            focal_length=f32(self.focal_length),
            aperture=f32(self.aperture),
            fov_scale=f32(self.FOV_SCALE),
        )

    def get_rays(self, seed=0, sample=0, model="thinlens") -> Rays:
        return generate_rays(self.params(), self.resolution, seed, sample, model)


class LegacyCamera(Camera):
    """Camera with the legacy line's fov convention: ``fov`` is the HALF
    horizontal angle (view_width = 2·tan(fov), 12_free_view.py:216,231) —
    the legacy scripts' ``set_fov(30)`` frames ~2x wider than the modern
    camera's. Everything else is shared."""

    FOV_SCALE = 1.0
