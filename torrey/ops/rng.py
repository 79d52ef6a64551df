"""Counter-based stateless RNG for the wavefront integrator.

Replacement for the reference's per-pixel curand XORWOW state
buffer (main.cu:54-62, C24 in SURVEY.md) and its vestigial CPU PCG (pcg.h,
C25).  Instead of a mutable state array in HBM we carry one uint32 PCG
state per ray lane through the bounce loop — seeded from
``(pixel_index, sample_index, seed)`` so every (pixel, sample) pair gets an
independent stream, the functional analog of
``curand_init(1984, pixel_index, 0, ...)`` (main.cu:61).

Generator: PCG-RXS-M-XS 32/32 (the same family as the reference's pcg.h),
3 multiplies + shifts per draw — far cheaper than threefry and
statistically solid for Monte Carlo rendering.  Bitwise equality with
curand is neither feasible nor required; parity is statistical (images
agree within noise at matched spp).  The megakernel runs these same
functions, so its streams are bit-identical to the XLA path's.
"""

from __future__ import annotations

import jax.numpy as jnp

# NOTE: plain Python ints, NOT jnp scalars — module-level jnp constants are
# committed device buffers and poison jit performance on this backend.
_MULT = 747796405
_INC = 2891336453


def _u32(x) -> jnp.ndarray:
    return jnp.uint32(x)


def _pcg_permute(state: jnp.ndarray) -> jnp.ndarray:
    word = ((state >> ((state >> _u32(28)) + _u32(4))) ^ state)
    word = word * _u32(277803737)
    return (word >> _u32(22)) ^ word


def seed_rays(pixel_index: jnp.ndarray, sample_index, seed: int = 1984) -> jnp.ndarray:
    """Derive per-ray uint32 PCG states.  Mixes the three inputs through two
    PCG rounds so that adjacent pixels/samples decorrelate."""
    s = (pixel_index.astype(jnp.uint32) * _u32(0x9E3779B9)
         + jnp.asarray(sample_index, jnp.uint32) * _u32(0x85EBCA6B)
         + _u32(seed))
    s = s * _u32(_MULT) + _u32(_INC)
    s = _pcg_permute(s) * _u32(_MULT) + _u32(_INC)
    return s


def next_uniform(state: jnp.ndarray):
    """Advance and draw one float32 uniform in [0, 1) per lane.
    Returns (new_state, u)."""
    state = state * _u32(_MULT) + _u32(_INC)
    word = _pcg_permute(state)
    # 24-bit mantissa -> exact float32 in [0, 1)
    u = (word >> _u32(8)).astype(jnp.float32) * (1.0 / (1 << 24))
    return state, u


def next_uniform2(state: jnp.ndarray):
    state, u1 = next_uniform(state)
    state, u2 = next_uniform(state)
    return state, u1, u2
