"""Runtime plumbing shared by every entry point: the platform route and the
persistent compile cache.

``route()`` is the one place that maps JAX's platform onto the code paths
the library has: ``"gpu"`` (an NVIDIA card) or ``"cpu"`` (tests and
rehearsals). Any other platform is an error, never a silent fallback.
"""

from __future__ import annotations

import os

_ROUTES = {"gpu": "gpu", "cuda": "gpu", "cpu": "cpu"}

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# fixed, gitignored cache directory in the checkout (the path is part of the
# cache key, so it must not move between runs)
DEFAULT_CACHE_DIR = os.path.join(ROOT, ".jax_cache")


def route(platform: str | None = None) -> str:
    """``"gpu"`` or ``"cpu"`` for ``platform`` (default: JAX's default
    backend); raises ``RuntimeError`` on any other platform."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    try:
        return _ROUTES[platform]
    except KeyError:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: this renderer runs on "
            f"an NVIDIA GPU ('gpu') or on the CPU ('cpu')") from None


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else the checkout's fixed
    ``.jax_cache`` directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``
    (programs that took over a second to compile) and return that
    directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def card_info() -> str | None:
    """``"<name>, <power limit>"`` of the first GPU as ``nvidia-smi`` reports
    it, or None where there is no ``nvidia-smi``."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def device_record() -> dict:
    """What every benchmark line carries about the device it ran on."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card_info()}
