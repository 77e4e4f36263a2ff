"""banggameengine_tpu — a simulation/game engine in JAX.

Brand-new implementation of the capabilities of the reference C++ engine
Skeletus/BangGameEngine (ECS + Bullet physics + bgfx renderer; see SURVEY.md):
structure-of-arrays world state in device memory, jitted
physics/transform/render pipelines, vmapped many-world simulation, and
shard_map scaling over device meshes.
"""

__version__ = "0.1.0"

import os as _os


def _enable_compilation_cache() -> None:
    """Persistent XLA compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache lives at ``<checkout>/.jax_cache``
    — a fixed path, since the path is part of the cache key — so every
    process started from this checkout (benchmarks, the smoke check, the
    GPU tests) reuses compiles.  Off for forced-CPU runs (tests): XLA:CPU
    cache entries are pinned to the host's machine features.  Opt out with
    ``BANG_NO_COMP_CACHE=1``.
    """
    if _os.environ.get("BANG_NO_COMP_CACHE"):
        return
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if _os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu":
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", default_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache``: the compile cache when
    ``JAX_COMPILATION_CACHE_DIR`` is unset."""
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


_enable_compilation_cache()


def _force_f32_matmuls() -> None:
    """f32-exact matmul precision engine-wide.

    The engine leans on matmul CONTRACTIONS as data movement — one-hot
    compaction/selection of f32 payload rows (solver partner velocities,
    warm-start impulse matching, the deferred shade resolve) — where a
    reduced-precision product (bf16 passes, or TF32 on a GPU's tensor
    cores, both ~3 decimal digits) silently corrupts the payload.  With
    ``highest`` every one-hot select returns its f32 rows bit-exactly and
    the flat and vmapped many-world layouts (identical math, different
    contraction shapes) agree: on an H100 (``chip_smoke.py``, 64 worlds,
    50 steps) their positions are equal under ``highest`` and differ by
    2.3e-5 under the default precision, which uses TF32.  Physics parity
    with the f32 Bullet reference requires this.  Callers wanting reduced-precision speed in their own
    code can locally override with
    ``jax.default_matmul_precision('default')``.
    """
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")


_force_f32_matmuls()

from banggameengine_tpu import math3d  # noqa: F401
from banggameengine_tpu.state import (  # noqa: F401
    InputFrame,
    StaticScene,
    StepEvents,
    WorldState,
)
