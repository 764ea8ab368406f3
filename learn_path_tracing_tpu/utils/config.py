"""Render configuration (the reference's module-level constants, as data).

Mirrors the knob set of 15_module.py:36-44 and 10_final/__main__.py:50-52:
resolution / spp / batch / propagate_limit / epsilon plus our device-side
options. Plain dataclass — hashable fields are jit-static by construction.
Every option is a field here or a keyword argument of the render functions;
the library reads no environment variables of its own.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    spp: int = 128
    batch: int = 1            # samples per progressive pass
    propagate_limit: int = 32
    epsilon: float = 1e-4
    seed: int = 0
    bsdf: str = "modern"          # diffuse | modern | legacy
    scene: str = "spheres"        # spheres | legacy
    camera_model: str = "thinlens"
    hit_backend: str = "auto"     # auto | xla | bvh
    early_exit: bool = True
    out: str | None = None        # output path override (stages/CLI)

    @property
    def resolution(self):
        return (self.width, self.height)

    @property
    def limit(self):
        return self.propagate_limit

    def with_(self, **kw) -> "RenderConfig":
        return replace(self, **kw)

    def to_dict(self) -> dict:
        return asdict(self)


# Stage presets (file:line cites in stages/*.py). Keys: modern stages 1-10,
# legacy stages as "l11".."l15".
STAGE_CONFIGS = {
    1: RenderConfig(width=256, height=256, spp=1),
    2: RenderConfig(spp=1),
    3: RenderConfig(spp=1),
    4: RenderConfig(spp=1),
    5: RenderConfig(spp=100),
    6: RenderConfig(spp=8192, bsdf="diffuse"),
    7: RenderConfig(spp=8192),
    8: RenderConfig(spp=8192),
    9: RenderConfig(spp=8192),
    10: RenderConfig(spp=8192),
    "l11": RenderConfig(width=640, height=360, spp=128, propagate_limit=10,
                        bsdf="legacy", hit_backend="auto"),
    "l12": RenderConfig(width=640, height=360, spp=128, propagate_limit=10,
                        bsdf="legacy"),
    "l13": RenderConfig(spp=128, bsdf="legacy"),
    "l14": RenderConfig(width=1500, height=1000, spp=32, bsdf="legacy",
                        scene="legacy"),
    "l15": RenderConfig(width=1500, height=1000, spp=32, bsdf="legacy",
                        scene="legacy"),
}
