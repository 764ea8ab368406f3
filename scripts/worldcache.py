"""Pickle cache of built LegacyWorldData for the mesh-scene scripts.

The SAH + wide-collapse build for the 23k-tri Yoimiya mesh takes a while
on one CPU core; the scripts iterate on
kernel/integrator code that does not touch the build, so they load a cached
device-ready pytree instead. Keyed on the source file's mtime — NOT safe
against builder-code changes, which is why bench.py and the library itself
do not use it (delete /tmp/lpt_worldcache-* after touching accel/ or io/).
"""

import os
import pickle
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Persistent XLA compile cache for every script that imports this module.
from learn_path_tracing_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

YOIMIYA = "/root/reference/legacy/Yoimiya.world.npy"


def load_world(path=YOIMIYA, cache=True):
    import jax
    import numpy as np

    from learn_path_tracing_tpu.scene.legacy_world import LegacyWorld
    from learn_path_tracing_tpu.stages.legacy_common import make_asset_path_map

    import hashlib

    tag = os.path.basename(path).replace("/", "_")
    # Key on the CONTENT of the sources that shape built world data, not the
    # git rev — a rev key invalidates on every commit, forcing minutes-long
    # SAH rebuilds for commits that never touched the builder.
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "learn_path_tracing_tpu")
    h = hashlib.sha256()
    deps = []
    for sub in ("accel", "io", "geometry"):
        d = os.path.join(pkg, sub)
        deps += [os.path.join(d, f) for f in sorted(os.listdir(d))
                 if f.endswith(".py")]
    deps.append(os.path.join(pkg, "scene", "legacy_world.py"))
    for f in deps:
        with open(f, "rb") as fh:
            h.update(fh.read())
    rev = h.hexdigest()[:12]
    cpath = (f"/tmp/lpt_worldcache-{tag}-{int(os.path.getmtime(path))}"
             f"-{rev}.pkl")
    if cache and os.path.exists(cpath):
        with open(cpath, "rb") as f:
            wd = pickle.load(f)
        return jax.tree.map(jax.device_put, wd)
    world = LegacyWorld()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        wd = world.load(path, path_map=make_asset_path_map())
    if cache:
        host = jax.tree.map(np.asarray, wd)
        with open(cpath, "wb") as f:
            pickle.dump(host, f)
    return wd
