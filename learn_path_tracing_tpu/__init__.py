"""learn_path_tracing_tpu — a JAX wavefront path-tracing framework.

A from-scratch rebuild of the capabilities of JeffreyXiang/learn_path_tracing
(a Taichi/CUDA "Ray Tracing in One Weekend" tracer) that runs on an NVIDIA
GPU (and on the CPU for tests):

- All compute is plain JAX/XLA.
- Rays, hits and materials are SoA pytrees of flat ``f32[N]`` / ``f32[N,3]``
  arrays — no per-thread control flow, everything is masked wavefront passes.
- Sampling uses a counter-based (stateless) RNG keyed on
  ``(seed, pixel, sample, bounce, dim)`` so renders are deterministic and
  invariant under resharding across a device mesh.
- Multi-chip scaling shards pixel tiles (and optionally the spp axis, with a
  ``psum`` radiance reduction) across a ``jax.sharding.Mesh`` via ``shard_map``.

Layout:
  core/        dtypes (pytrees), RNG, color pipeline, image I/O
  geometry/    sphere / triangle / AABB intersection math
  bsdf/        sampling primitives and BSDF scatter functions
  camera/      pinhole & thin-lens cameras, free-fly controls
  integrator/  wavefront renderer (bounce scan, spp accumulation)
  accel/       SAH BVH build (host) + traversal (device)
  scene/       World containers, .world.npy serialization
  io/          OBJ/MTL loading, textures, environment maps, PNG
  parallel/    device-mesh sharding of the render loop
  models/      built-in scenes (staged tutorial scenes, character scenes)
  stages/      runnable stage scripts mirroring the reference's 1→10 surface
"""

__version__ = "0.1.0"
