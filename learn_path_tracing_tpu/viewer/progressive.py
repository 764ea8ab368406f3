"""Progressive accumulation renderer with movement-aware restart.

Mirrors the legacy ``render(moved)`` loop
(/root/reference/legacy/PT_in_one_weekend/15_module.py:1022-1036): an
accumulator image plus an spp counter that reset when the camera moves and
keep integrating otherwise; the display frame is ``(acc / spp) ** (1/2.2)``
(legacy line uses plain gamma, no ACES).

``ti.GUI`` has no analog on a headless GPU host — the interactive surface
here is either a frame callback (PNG stream / notebook display, see
viewer/serve.py) or the scripted flythrough in stages/l12_free_view.py.
Camera state persists across frames as an in-memory render-resume
checkpoint; ``state()``/``restore()`` expose it for disk checkpointing (the
accumulator + spp + RNG counters are the complete resume state thanks to
the counter-based RNG).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.camera import Camera
from ..integrator.wavefront import render_accumulate


@functools.partial(jax.jit, static_argnames=())
def _to_frame(acc, spp):
    return jnp.maximum(acc / jnp.maximum(spp, 1.0), 0.0) ** (1.0 / 2.2)


@jax.jit
def _axpy(acc, img, w):
    return acc + img * w


class ProgressiveRenderer:
    def __init__(self, world_data, camera: Camera, resolution,
                 spp_per_frame: int = 32, limit: int = 32, seed: int = 0,
                 bsdf: str = "legacy", scene: str = "legacy",
                 camera_model: str = "thinlens", hit_backend: str = "auto",
                 preview_spp: int = 0, preview_limit: int = 2,
                 engine: str = "auto"):
        """``preview_spp > 0`` enables motion preview: while the camera is
        moving, frames render at ``preview_spp`` samples and ``preview_limit``
        bounces (first hit + one scatter + env ≈ shaded geometry) instead of
        the full quality settings, so free-fly stays responsive on scenes
        whose full pass is below interactive rate (the 23k-tri mesh scenes —
        the reference free-flies such scenes at 640x360, 12_free_view.py:26-30).
        The first still frame discards the preview and restarts clean
        accumulation at full quality.

        ``engine``: 'wavefront' (fixed bounce-scan accumulate),
        'hybrid' (dense-primary + shared-pool integrator,
        integrator/hybrid.py), or 'auto' — hybrid for legacy scenes on the
        GPU, wavefront otherwise.
        Identical RNG counters either way, so switching engines never
        changes the converged image."""
        self.world_data = world_data
        self.camera = camera
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self.spp_per_frame = int(spp_per_frame)
        self.limit = int(limit)
        self.seed = int(seed)
        self.bsdf = bsdf
        self.scene = scene
        self.camera_model = camera_model
        self.hit_backend = hit_backend
        self.preview_spp = int(preview_spp)
        self.preview_limit = int(preview_limit)
        if engine == "auto":
            from ..utils.runtime import route

            engine = ("hybrid" if scene == "legacy" and route() == "gpu"
                      else "wavefront")
        self.engine = engine
        w, h = self.resolution
        self.acc = jnp.zeros((w * h, 3), jnp.float32)
        self.spp = 0
        self._preview_only = False

    def _accumulate(self, acc, sample_start, spp, limit):
        """acc + spp more samples' radiance sums (engine-dispatched)."""
        if self.engine == "hybrid":
            from ..integrator.hybrid import render_hybrid

            img, _ = render_hybrid(
                self.world_data, self.camera.params(), self.resolution,
                spp=spp, limit=limit, seed=self.seed, bsdf=self.bsdf,
                camera_model=self.camera_model, scene=self.scene,
                hit_backend=self.hit_backend,
                sample_base=jnp.uint32(sample_start))
            w, h = self.resolution
            return _axpy(acc, img.reshape(w * h, 3), jnp.float32(spp))
        acc, _ = render_accumulate(
            self.world_data, self.camera.params(), acc,
            jnp.uint32(sample_start), self.resolution, spp,
            limit=limit, seed=self.seed, bsdf=self.bsdf,
            camera_model=self.camera_model, scene=self.scene,
            hit_backend=self.hit_backend)
        return acc

    def render(self, moved: bool = True):
        """Add one batch of samples; reset the accumulator if the camera
        moved. Returns the current display frame ``f32[W,H,3]``."""
        w, h = self.resolution
        if moved and self.preview_spp:
            self.acc = self._accumulate(
                jnp.zeros((w * h, 3), jnp.float32), 0, self.preview_spp,
                self.preview_limit)
            self.spp = self.preview_spp
            self._preview_only = True
            return self.frame()
        if moved or self._preview_only:
            self.acc = jnp.zeros((w * h, 3), jnp.float32)
            self.spp = 0
            self._preview_only = False
        self.acc = self._accumulate(self.acc, self.spp, self.spp_per_frame,
                                    self.limit)
        self.spp += self.spp_per_frame
        return self.frame()

    def frame(self):
        w, h = self.resolution
        return _to_frame(self.acc, jnp.float32(self.spp)).reshape(w, h, 3)

    # ------------------------------------------------- resume checkpoint --
    def state(self) -> dict:
        """Serializable render-resume state (accumulator + counters)."""
        return {
            "acc": np.asarray(self.acc),
            "spp": self.spp,
            "seed": self.seed,
            "resolution": self.resolution,
        }

    def restore(self, state: dict) -> None:
        if tuple(state["resolution"]) != self.resolution:
            raise ValueError("resolution mismatch")
        self.acc = jnp.asarray(state["acc"])
        self.spp = int(state["spp"])
        self.seed = int(state["seed"])
