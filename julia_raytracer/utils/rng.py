"""Counter-based per-lane RNG (PCG-RXS-M-XS 32-bit).

The reference leans on Julia's *global* `rand()` (src/sampling.jl:18-22),
which is shared across threads and makes renders non-deterministic. On a
wavefront we instead key a counter-based generator by
(pixel, sample, seed) so every lane owns an independent stream, renders
are bit-deterministic, and results are invariant to how the ray axis is
sharded across devices.

State is a single uint32 per lane; each draw advances the LCG and applies
the RXS-M-XS output permutation. Quality is ample for Monte Carlo
rendering and it is pure elementwise work.
"""

from __future__ import annotations

import jax.numpy as jnp

_MUL = jnp.uint32(747796405)
_INC = jnp.uint32(2891336453)
_MIX = jnp.uint32(277803737)


def _pcg_permute(state):
    word = ((state >> ((state >> jnp.uint32(28)) + jnp.uint32(4))) ^ state) * _MIX
    return (word >> jnp.uint32(22)) ^ word


def seed_state(pixel_id, sample_id, seed: int = 0):
    """Hash (pixel, sample, seed) into a well-mixed uint32 state per lane."""
    s = pixel_id.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
    s = s + sample_id.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B)
    s = s + jnp.uint32(seed) * jnp.uint32(0xC2B2AE35)
    # two warm-up rounds decorrelate nearby (pixel, sample) pairs
    s = s * _MUL + _INC
    s = _pcg_permute(s) * _MUL + _INC
    return s


def next_uint32(state):
    state = state * _MUL + _INC
    return _pcg_permute(state), state


def rand1f(state):
    """One float in [0, 1) per lane; returns (value, new_state)."""
    bits, state = next_uint32(state)
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(2.0**-24), state


def rand2f(state):
    a, state = rand1f(state)
    b, state = rand1f(state)
    return jnp.stack([a, b], axis=-1), state


def rand3f(state):
    a, state = rand1f(state)
    b, state = rand1f(state)
    c, state = rand1f(state)
    return jnp.stack([a, b, c], axis=-1), state
