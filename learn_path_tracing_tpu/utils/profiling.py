"""Tracing / profiling utilities.

The reference's only observability is wall-clock prints and tqdm bars
(SURVEY.md §5). Here:

- ``timed``: context manager printing wall time + derived Mrays/s;
- ``trace``: context manager wrapping ``jax.profiler`` traces (view with
  TensorBoard or xprof);
- ``RayStats``: accumulates per-pass live-ray counters the integrator
  already returns (segments) into a structured report.
"""

from __future__ import annotations

import contextlib
import json
import time


@contextlib.contextmanager
def timed(label: str, segments=None):
    """Print elapsed wall time; if ``segments`` is a callable returning the
    traced ray-segment count, also print Mrays/s."""
    t0 = time.time()
    yield
    dt = time.time() - t0
    msg = f"[{label}] {dt:.3f}s"
    if segments is not None:
        segs = float(segments() if callable(segments) else segments)
        msg += f"  {segs:.3e} segments  {segs / dt / 1e6:.1f} Mrays/s"
    print(msg)


@contextlib.contextmanager
def trace(logdir: str = "/tmp/lpt_trace"):
    """jax.profiler trace around a block (device timeline in TensorBoard)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class RayStats:
    """Structured render statistics (the 'metrics/logging' subsystem)."""

    def __init__(self):
        self.records = []

    def add(self, *, label: str, seconds: float, segments: float,
            pixels: int, spp: int):
        self.records.append({
            "label": label,
            "seconds": round(seconds, 4),
            "segments": segments,
            "pixels": pixels,
            "spp": spp,
            "mrays_per_sec": round(segments / max(seconds, 1e-9) / 1e6, 2),
            "avg_bounces": round(segments / max(pixels * spp, 1), 3),
        })

    def report(self) -> str:
        return "\n".join(json.dumps(r) for r in self.records)
