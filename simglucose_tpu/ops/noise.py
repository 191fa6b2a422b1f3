"""Streaming CGM noise as batched JAX functions.

The reference generates colored CGM noise as (sensor/noise_gen.py):
  1. an AR(1) recursion on a 15-min lattice: e[0] = randn();
     e[k] = PACF * (e[k-1] + randn())                       (:85-88)
  2. a Johnson-SU transform of each lattice value:
     eps = xi + lambda * sinh((e - gamma)/delta)            (:11-12)
  3. cubic interpolation of the transformed lattice down to the sensor's
     sample_time, in blocks of 10 lattice intervals          (:30-56)

Here the same chain is a *streaming state machine*: the state carries the raw
AR(1) value and the 4 transformed lattice points bracketing the current
15-min segment; each new lattice point costs one ``jax.random.normal`` draw,
and each sample is one local cubic (Catmull-Rom) evaluation.  This is O(1)
state and branchless per sample, so it vmaps over patient batches whose
episode phases have diverged (auto-reset), unlike the reference's 11-point
block spline.

Fidelity note: the reference interpolates each 150-min block with a global
not-a-knot cubic spline; the native path uses the local Catmull-Rom cubic
through the same lattice points.  Both interpolate the lattice exactly (they
agree at every 15-min node and share the AR(1)/Johnson law); they differ only
in sub-segment wiggle.  For bit-exact reference traces use the precomputed
noise path (:mod:`simglucose_tpu.compat.noise`).

Sample timeline: the n-th noise value consumed (n = 0, 1, ...) corresponds to
lattice time tau = (n + 1) * sample_time — the reference's block resampler
drops the t=0 point of each block (noise_gen.py:47), so the very first sample
already sits sample_time minutes into the lattice.

These functions operate on a single (scalar-state) sensor and are vmapped
over the patient batch by the env layer; ``jax.random.fold_in`` keys a
counter-based stream per sensor.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from simglucose_tpu.core.types import SensorParams

MDL_SAMPLE_TIME = 15  # min between AR(1) lattice points (noise_gen.py:17)


def johnson_transform_su(params: SensorParams, x: jnp.ndarray) -> jnp.ndarray:
    """xi + lambda * sinh((x - gamma)/delta)  (noise_gen.py:11-12)."""
    return params.xi + params.lam * jnp.sinh((x - params.gamma) / params.delta)


def noise_lattice_init(
    params: SensorParams, key: jax.Array, dtype=jnp.float32
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Initialize the AR(1) lattice window for segment 0.

    Returns (e, lattice[4], seg, lattice_next): lattice holds transformed
    values at lattice indices [-1, 0, 1, 2], with the phantom index -1
    clamped to index 0 (the reference's first block spline has no left
    neighbor either).  Invariant maintained thereafter: lattice covers
    indices [seg-1, seg+2] and lattice_next == seg + 3.
    """
    z0 = jax.random.normal(jax.random.fold_in(key, 0), dtype=dtype)
    z1 = jax.random.normal(jax.random.fold_in(key, 1), dtype=dtype)
    z2 = jax.random.normal(jax.random.fold_in(key, 2), dtype=dtype)
    e0 = z0  # first lattice point is a plain randn (noise_gen.py:85-86)
    e1 = params.PACF * (e0 + z1)
    e2 = params.PACF * (e1 + z2)
    eps0 = johnson_transform_su(params, e0)
    eps1 = johnson_transform_su(params, e1)
    eps2 = johnson_transform_su(params, e2)
    lattice = jnp.stack([eps0, eps0, eps1, eps2], axis=-1)
    return e2, lattice, jnp.int32(0), jnp.int32(3)


def _catmull_rom(lattice: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Cubic Hermite through lattice[...,1] and lattice[...,2] at u in [0,1],
    with central-difference tangents (Catmull-Rom)."""
    p0, p1, p2, p3 = (lattice[..., i] for i in range(4))
    m1 = 0.5 * (p2 - p0)
    m2 = 0.5 * (p3 - p1)
    u2 = u * u
    u3 = u2 * u
    return (
        (2.0 * u3 - 3.0 * u2 + 1.0) * p1
        + (u3 - 2.0 * u2 + u) * m1
        + (-2.0 * u3 + 3.0 * u2) * p2
        + (u3 - u2) * m2
    )


def noise_next(
    params: SensorParams,
    sample_time: int,
    e: jnp.ndarray,
    lattice: jnp.ndarray,
    seg: jnp.ndarray,
    lattice_next: jnp.ndarray,
    sample_count: jnp.ndarray,
    key: jax.Array,
) -> Tuple[jnp.ndarray, Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Noise value for sample index ``sample_count``; advances the lattice.

    Branchless (masked) updates — safe under vmap with divergent per-patient
    phases.  ``sample_time`` is static and <= 5 < 15, so at most one new
    lattice point is needed per sample.

    Returns (noise_value, (e, lattice, seg, lattice_next)).
    """
    dtype = lattice.dtype
    tau = (sample_count + 1) * sample_time  # minutes on the lattice timeline
    k = (tau // MDL_SAMPLE_TIME).astype(jnp.int32)
    u = (tau - k * MDL_SAMPLE_TIME).astype(dtype) / MDL_SAMPLE_TIME

    need = (k + 2) >= lattice_next
    z = jax.random.normal(jax.random.fold_in(key, lattice_next), dtype=dtype)
    e_new = params.PACF * (e + z)
    eps_new = johnson_transform_su(params, e_new)
    e = jnp.where(need, e_new, e)
    lattice = jnp.where(
        need,
        jnp.concatenate([lattice[..., 1:], eps_new[..., None]], axis=-1),
        lattice,
    )
    lattice_next = jnp.where(need, lattice_next + 1, lattice_next)

    val = _catmull_rom(lattice, u)
    return val, (e, lattice, k, lattice_next)


def noise_pregenerate(
    params: SensorParams,
    key: jax.Array,
    n_samples: int,
    sample_time: int,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """The first ``n_samples`` values of the streaming noise chain as one
    vectorized [n_samples] array — BIT-IDENTICAL to ``n_samples`` successive
    :func:`noise_next` calls from :func:`noise_lattice_init` with the same
    ``key`` (pinned by tests/test_rollout_pregen.py).

    This is the fixed-horizon fast path (envs/rollout.py ``rollout(pregen=
    True)``): the noise stream is state-independent, so hoisting it out of
    the env scan removes the per-step threefry ``fold_in`` + ``normal``
    (erf_inv) from the hot loop; the env then runs in exogenous-noise mode
    indexing this plane by ``sample_count``.

    Everything is parallel except the AR(1) recurrence over lattice points
    (noise_gen.py:85-88), kept as a ``lax.scan`` so the float op order — and
    therefore every bit — matches the streaming path; the lattice is tiny
    (one point per 15 simulated minutes, noise_gen.py:17).
    """
    # lattice points needed: sample n (n = 0..n_samples-1) reads window
    # [k-1, k+2] at k = ((n+1)*sample_time) // 15 — same indexing as
    # noise_next.
    max_k = (n_samples * sample_time) // MDL_SAMPLE_TIME
    n_lat = max_k + 3  # indices 0 .. max_k+2
    # z_j = normal(fold_in(key, j)) — the streaming draw order: init uses
    # counters 0..2 (noise_lattice_init), advancement uses counter ==
    # lattice index (noise_next's fold_in(key, lattice_next)).
    zs = jax.vmap(
        lambda j: jax.random.normal(jax.random.fold_in(key, j), dtype=dtype)
    )(jnp.arange(n_lat))

    # e_0 = z_0; e_j = PACF * (e_{j-1} + z_j)  — sequential scan keeps the
    # exact streaming float op order (an associative-scan form would round
    # differently).
    def ar_body(e, z):
        e = params.PACF * (e + z)
        return e, e

    _, e_rest = jax.lax.scan(ar_body, zs[0], zs[1:])
    e_all = jnp.concatenate([zs[:1], e_rest])
    eps = johnson_transform_su(params, e_all)  # [n_lat]

    n = jnp.arange(n_samples, dtype=jnp.int32)
    tau = (n + 1) * sample_time
    k = (tau // MDL_SAMPLE_TIME).astype(jnp.int32)
    u = (tau - k * MDL_SAMPLE_TIME).astype(dtype) / MDL_SAMPLE_TIME
    # window [k-1, k, k+1, k+2]; the phantom index -1 clamps to 0, exactly
    # like noise_lattice_init's first window.
    lattice = jnp.stack(
        [eps[jnp.maximum(k - 1, 0)], eps[k], eps[k + 1], eps[k + 2]],
        axis=-1,
    )
    return _catmull_rom(lattice, u)
