"""Runtime configuration.

The reference scatters its knobs across compile-time constants
(SURVEY.md §5 "Config/flag system": MAX_DEPTH 50 radiance.cuh:12, RR start
depth 5 radiance.cuh:68, camera epsilon 1e-5 main.cu:298, default 2
samples/frame main.cu:131, RNG seed 1984 main.cu:61, UI ranges
imgui_manager.cpp:101-105).  Here they live in one dataclass.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    max_depth: int = 50            # radiance.cuh:12
    rr_start_depth: int = 5        # radiance.cuh:68
    camera_epsilon: float = 1e-5   # main.cu:298
    samples_per_frame: int = 2     # main.cu:131
    seed: int = 1984               # main.cu:61
    fov_min: float = 10.0          # imgui_manager.cpp:101
    fov_max: float = 120.0
    spf_min: int = 1               # imgui_manager.cpp:105
    spf_max: int = 10
    move_speed: float = 0.5        # imgui_manager.cpp WASD speed (:143)
    mouse_sensitivity: float = 0.1  # imgui_manager.cpp orbit (:254)
    # block on the device each frame (cudaDeviceSynchronize analog,
    # main.cu:336).  False lets frames pipeline on the device, for batch
    # throughput.
    sync_each_frame: bool = True
    # next-event estimation for point lights — a beyond-reference
    # capability (the reference parses point lights but never samples
    # them, SURVEY.md §3.5).  Every compute path implements it.
    enable_nee: bool = False


# the checkout this package was imported from: the compile cache lives in
# it, so the cache's path (part of JAX's cache key) stays fixed
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str | None:
    """Directory this program gives JAX's persistent compilation cache:
    ``<checkout>/.jax_cache``, or None when ``JAX_COMPILATION_CACHE_DIR`` is
    set (JAX then reads that variable itself and the program sets
    nothing)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_CHECKOUT, ".jax_cache")


def setup_jax() -> None:
    """Process-wide JAX settings: the persistent compilation cache, which
    makes a second process's first frame skip the compile."""
    import jax
    cache_dir = compile_cache_dir()
    if cache_dir is not None:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
