"""Rollout engines: jit(vmap(scan)) over the functional env.

This replaces the reference's ``SimObj.simulate`` while-loop + pathos
process pool (reference: simulation/sim_engine.py:29-39,65-76) with a single
compiled program: time = ``lax.scan`` (sequential on device), patients =
``vmap`` (lanes), devices = shard_map over a Mesh
(:mod:`simglucose_tpu.parallel.sharding`).

Two engines:
  * :func:`rollout`         — fixed-horizon closed-loop rollout of a
                              (controller, env) pair, stacked histories.
  * :func:`rollout_autoreset` — RL-style batched rollout with masked
                              re-initialization when episodes terminate
                              (the reference gym wrapper builds a whole new
                              env per reset, simglucose_gym_env.py:48-51;
                              here that is a masked state swap).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from simglucose_tpu.analysis.risk import risk_diff_reward
from simglucose_tpu.controllers.functional import ControllerFn
from simglucose_tpu.core.types import EnvState, StepResult
from simglucose_tpu.envs.functional import (
    EnvConfig,
    EnvParams,
    env_reset,
    env_step,
)


def pregen_env(
    cfg: EnvConfig,
    params: EnvParams,
    key: jax.Array,
    n_steps: int,
    start_min: jnp.ndarray,
) -> Tuple[EnvConfig, EnvParams]:
    """Hoist the state-independent random streams out of the env scan.

    The native CGM-noise chain (ops/noise.py) and the random meal scenario
    (scenario/meal.py) depend only on (key, sample index / minute) — never
    on the trajectory — so for a FIXED-horizon rollout both streams can be
    pregenerated as vectorized planes and the env run in exogenous mode
    indexing them.  This removes the per-step threefry ``fold_in`` +
    ``normal`` (erf_inv) and the per-step candidate daily-plan draw (18
    variates + 12 ndtri/ndtr for a regen that fires once per simulated day)
    from the scan body, leaving essentially the ODE + device math — the
    fusion-boundary cost the reference's 1-minute loop pays per step
    (reference: simulation/sim_engine.py:33-37) collapses into one parallel
    pregeneration pass.

    The planes reproduce the streaming draws BIT-exactly
    (noise_pregenerate / meals_pregenerate; key derivation mirrors
    env_reset's split), and the produced trajectories match the streaming
    path to within XLA fusion/FMA-contraction ulps (~1e-7 relative,
    tests/test_rollout_pregen.py) — far below the native-mode integrator
    tolerance.  Only fixed-horizon engines can use this — auto-reset
    re-keys the streams at data-dependent times.

    Returns ``(cfg', params')`` with the exogenous modes set and the planes
    attached.  Single-env semantics (vmap for a batch).
    """
    from simglucose_tpu.ops.noise import noise_pregenerate
    from simglucose_tpu.scenario.meal import meals_pregenerate

    if cfg.noise_mode != "native" or cfg.scenario_mode != "random":
        raise ValueError(
            "pregen requires noise_mode='native' and scenario_mode='random' "
            f"(got {cfg.noise_mode!r}/{cfg.scenario_mode!r}) — other modes "
            "already carry their streams as arrays"
        )
    dtype = params.patient.x0.dtype
    # env_reset's split — the sensor/scenario subkeys must match exactly
    _, k_sensor, k_scenario = jax.random.split(key, 3)
    noise_seq = noise_pregenerate(
        params.sensor, k_sensor, n_steps + 2, cfg.sample_time, dtype=dtype
    )  # reset consumes samples 0-1 (env.py:126,142), steps 2..n_steps+1
    meal_seq = meals_pregenerate(
        k_scenario, start_min, n_steps * cfg.sample_time, dtype=dtype
    )
    cfg = dataclasses.replace(
        cfg, noise_mode="exogenous", scenario_mode="exogenous"
    )
    return cfg, params._replace(noise_seq=noise_seq, meal_seq=meal_seq)


def rollout(
    cfg: EnvConfig,
    params: EnvParams,
    key: jax.Array,
    ctrl_init: Any,
    ctrl_fn: ControllerFn,
    n_steps: int,
    start_min: jnp.ndarray = 0,
    init_state: Optional[jnp.ndarray] = None,
    reward_fun=risk_diff_reward,
    pregen: bool = False,
) -> Tuple[EnvState, StepResult, StepResult]:
    """Closed-loop rollout of ``n_steps`` env steps for ONE env.

    Returns (final_env_state, reset_result, stacked_step_results); vmap over
    (params/key/start_min) for a batch.  The controller acts on the previous
    step's result, exactly like the reference loop (sim_engine.py:33-37).

    ``pregen=True`` hoists the noise/meal streams out of the scan — same
    trajectories to within compiler-rounding ulps; requires the
    native/random modes.  The planes are computed by the bit-exact
    pregenerators (:func:`~simglucose_tpu.ops.noise.noise_pregenerate` /
    :func:`~simglucose_tpu.scenario.meal.meals_pregenerate`) and fed to the
    scan as **xs** per-step slices.  It exists as a verified building
    block (the pregenerators also back the bit-exactness tests), not as the
    default fast path: the scan body is bound by its many small fusions,
    not by the stream draws, and the vmapped xs feeding adds strided
    per-step slices.  The
    returned final EnvState's sensor-lattice/scenario internals are frozen
    at their reset values (the exogenous planes replace them).
    """
    if pregen:
        from simglucose_tpu.ops.noise import noise_pregenerate
        from simglucose_tpu.scenario.meal import meals_pregenerate

        if cfg.noise_mode != "native" or cfg.scenario_mode != "random":
            raise ValueError(
                "pregen requires noise_mode='native' and scenario_mode="
                f"'random' (got {cfg.noise_mode!r}/{cfg.scenario_mode!r})"
            )
        dtype = params.patient.x0.dtype
        st = cfg.sample_time
        # env_reset's split — the sensor/scenario subkeys must match exactly
        _, k_sensor, k_scenario = jax.random.split(key, 3)
        noise_seq = noise_pregenerate(
            params.sensor, k_sensor, n_steps + 2, st, dtype=dtype
        )  # reset consumes samples 0-1 (env.py:126,142), steps 2..n_steps+1
        meal_seq = meals_pregenerate(
            k_scenario, start_min, n_steps * st, dtype=dtype
        )
        cfg_reset = dataclasses.replace(cfg, noise_mode="exogenous")
        state, reset_res = env_reset(
            cfg_reset,
            params._replace(noise_seq=noise_seq),
            key,
            start_min=start_min,
            init_state=init_state,
        )
        cfg_xs = dataclasses.replace(cfg, noise_mode="xs", scenario_mode="xs")

        def body_xs(carry, x):
            meals_i, noise_i = x
            state, ctrl_state, prev_res = carry
            ctrl_state, action = ctrl_fn(ctrl_state, prev_res)
            state, res = env_step(
                cfg_xs,
                params,
                state,
                action,
                reward_fun=reward_fun,
                exo_meals=meals_i,
                exo_noise=noise_i,
            )
            return (state, ctrl_state, res), res

        # The barrier forces the planes to MATERIALIZE before the scan —
        # without it XLA fuses the pregeneration into the scan body and
        # recomputes the full-horizon plan lookup every step (measured
        # 47.7KB accessed per step-lane vs 185B; 7M vs 23M steps/s).
        xs = jax.lax.optimization_barrier(
            (meal_seq.reshape(n_steps, st), noise_seq[2:])
        )
        (state, _, _), traj = jax.lax.scan(
            body_xs, (state, ctrl_init, reset_res), xs
        )
        return state, reset_res, traj

    state, reset_res = env_reset(
        cfg, params, key, start_min=start_min, init_state=init_state
    )

    def body(carry, _):
        state, ctrl_state, prev_res = carry
        ctrl_state, action = ctrl_fn(ctrl_state, prev_res)
        state, res = env_step(cfg, params, state, action, reward_fun=reward_fun)
        return (state, ctrl_state, res), res

    (state, _, _), traj = jax.lax.scan(
        body, (state, ctrl_init, reset_res), None, length=n_steps
    )
    return state, reset_res, traj


def rollout_batch(
    cfg: EnvConfig,
    params: EnvParams,
    keys: jax.Array,
    ctrl_init: Any,
    ctrl_fn: ControllerFn,
    n_steps: int,
    start_min: jnp.ndarray = 0,
    reward_fun=risk_diff_reward,
    ctrl_in_axes=None,
    pregen: bool = False,
):
    """vmapped :func:`rollout` over a leading batch axis of params/keys.

    ``params`` leaves must carry the batch axis; ``start_min``/``ctrl_init``
    are broadcast if unbatched.  Pass ``ctrl_in_axes=0`` when the controller
    state is per-patient (e.g. batched BB therapy params).  Histories come
    back as [B, T] arrays.  ``pregen`` — see :func:`rollout`.
    """
    batched = jax.vmap(
        lambda p, k, sm, ci: rollout(
            cfg,
            p,
            k,
            ci,
            ctrl_fn,
            n_steps,
            start_min=sm,
            reward_fun=reward_fun,
            pregen=pregen,
        ),
        in_axes=(0, 0, 0, ctrl_in_axes),
    )
    B = keys.shape[0]
    start_min = jnp.broadcast_to(jnp.asarray(start_min, jnp.int32), (B,))
    return batched(params, keys, start_min, ctrl_init)


# ---------------------------------------------------------------------------
# Auto-reset batched env (RL path)
# ---------------------------------------------------------------------------


def make_reset_candidates(
    cfg: EnvConfig, params: EnvParams, state: EnvState, salt: Optional[int] = None
) -> Tuple[EnvState, StepResult]:
    """One fresh-episode candidate for a SINGLE env (vmap for a batch),
    keyed exactly like :func:`autoreset_step`'s in-line reset:
    ``fold_in(state.key, patient.t)`` -> (random start hour, reset key).

    The cadenced engines draw candidates once per chunk instead of once per
    step; a lane that terminates mid-chunk adopts a chunk candidate —
    same marginal law (the start hour is uniform and the episode key fresh),
    the start state is just drawn up to ``reset_cadence`` steps early.
    ``salt`` folds an extra static index into the key so a chunk can draw
    SEVERAL independent candidates (``salt=None`` keeps the original
    stream)."""
    new_key = jax.random.fold_in(state.key, state.patient.t)
    if salt is not None:
        new_key = jax.random.fold_in(new_key, salt)
    k_hour, k_reset = jax.random.split(new_key)
    hour = jax.random.randint(k_hour, (), 0, 24)
    return env_reset(cfg, params, k_reset, start_min=hour * 60)


def autoreset_step_with_candidate(
    cfg: EnvConfig,
    params: EnvParams,
    state: EnvState,
    action,
    cand: EnvState,
    cand_res: StepResult,
    n_adopt: Optional[jnp.ndarray] = None,
    reward_fun=risk_diff_reward,
):
    """:func:`autoreset_step` semantics with PRE-DRAWN reset candidate(s):
    the env steps (scenario regen deferred to the chunk boundary,
    ``scenario_regen=False``) and, where done, adopts a candidate instead of
    computing a fresh reset in-line.  Single-env; vmap for a batch.

    With ``n_adopt=None``, ``cand``/``cand_res`` are one candidate and a
    lane that terminates twice within one chunk re-adopts it (an identical
    episode start).  With ``n_adopt`` (int32 adoption count), the candidate
    leaves carry a leading axis ``[C, ...]`` and termination number *k*
    adopts candidate ``min(k, C-1)`` — the identical-replay event then
    requires C+1 terminations of the SAME lane in one chunk (p^(C+1)
    instead of p^2); returns an extra updated count."""
    state, res = env_step(
        cfg, params, state, action, reward_fun=reward_fun, scenario_regen=False
    )
    if n_adopt is not None:
        C = jax.tree.leaves(cand)[0].shape[0]
        idx = jnp.minimum(n_adopt, C - 1)
        cand = jax.tree.map(lambda a: a[idx], cand)
        cand_res = jax.tree.map(lambda a: a[idx], cand_res)

    def pick(a, b):
        return jnp.where(
            jnp.reshape(res.done, res.done.shape + (1,) * (a.ndim - res.done.ndim)),
            a,
            b,
        )

    reset_state = jax.tree.map(pick, cand, state)
    carry_res = jax.tree.map(pick, cand_res, res)
    if n_adopt is not None:
        return reset_state, res, carry_res, n_adopt + res.done.astype(jnp.int32)
    return reset_state, res, carry_res


def autoreset_step(
    cfg: EnvConfig,
    params: EnvParams,
    state: EnvState,
    action,
    reward_fun=risk_diff_reward,
    horizon_steps: Optional[int] = None,
):
    """One env step with gym-style auto-reset for a SINGLE env (vmap for a
    batch).

    When the step terminates, the env is re-initialized from a fresh key
    with a random start hour — the functional analog of the reference gym
    wrapper's brand-new-env-per-reset (simglucose_gym_env.py:48-51,66-67).

    ``horizon_steps`` additionally resets episodes that reach the horizon
    (Gymnasium truncation — the vector env's ``horizon_days``); the return
    then gains a fourth element, the per-env truncated flag.

    Returns ``(state, res, carry_res)``:
      * ``res``       — the terminal StepResult of the step that just ran
                        (done=True and the terminal observation when the
                        episode ended; Gymnasium's ``final_observation``);
      * ``carry_res`` — what the NEXT policy invocation must see: equal to
                        ``res`` for live envs, and the new episode's *reset*
                        StepResult for terminated ones.  The reference gym
                        wrapper hands the reset observation to the agent
                        after done (simglucose_gym_env.py:48-51); feeding
                        ``carry_res`` forward reproduces that — the first
                        action of an episode is computed from the new
                        episode's CGM, never the previous terminal one.
    The returned ``state`` already belongs to the new episode where done.
    """
    state, res = env_step(cfg, params, state, action, reward_fun=reward_fun)
    if horizon_steps is None:
        need_reset = res.done
    else:
        trunc = state.episode_step >= horizon_steps
        need_reset = res.done | trunc
    fresh, fresh_res = make_reset_candidates(cfg, params, state)

    def pick(a, b):
        return jnp.where(
            jnp.reshape(
                need_reset, need_reset.shape + (1,) * (a.ndim - need_reset.ndim)
            ),
            a,
            b,
        )

    reset_state = jax.tree.map(pick, fresh, state)
    carry_res = jax.tree.map(pick, fresh_res, res)
    if horizon_steps is None:
        return reset_state, res, carry_res
    return reset_state, res, carry_res, trunc


def make_batch_rollout_fn(
    cfg: EnvConfig,
    ctrl_fn: ControllerFn,
    n_steps: int,
    reward_fun=risk_diff_reward,
    donate: bool = True,
    reset_cadence: int = 1,
):
    """Compiled batched auto-reset rollout: (params[B], state[B], ctrl_state)
    -> (state[B], traj[T, B]).  The workhorse behind bench.py and the PPO
    actor.  State is donated so long runs reuse buffers.

    ``reset_cadence=K > 1`` amortizes the rare-path sampling over chunks of
    K steps (the XLA analog of the pallas kernel's ``regen_every``): fresh-
    episode reset candidates and the midnight scenario regeneration are
    computed once per chunk instead of every step, leaving the scan body as
    pure ODE + device math.  Trajectories of non-terminating lanes are
    unchanged (the deferred regen is trajectory-exact — scenario/meal.py
    :func:`~simglucose_tpu.scenario.meal.scenario_lookup_for_step`); lanes
    that terminate adopt a candidate whose start state was drawn up to K
    steps early — same law, different stream.  Requires ``n_steps % K == 0``
    and ``K * sample_time < 300`` (the post-midnight meal-free window)."""

    step1 = partial(autoreset_step, cfg, reward_fun=reward_fun)
    K = int(reset_cadence)
    if K > 1:
        if n_steps % K:
            raise ValueError(f"n_steps={n_steps} not divisible by {K=}")
        if K * cfg.sample_time >= 300:
            raise ValueError(
                f"reset_cadence*sample_time = {K * cfg.sample_time} min must "
                "stay inside the 5h post-midnight meal-free window "
                "(scenario/meal.py TIME_LB) for the deferred regen to be "
                "trajectory-exact"
            )
    stepK = partial(autoreset_step_with_candidate, cfg, reward_fun=reward_fun)

    def run(params, state: EnvState, ctrl_init, prev_res: StepResult):
        """``ctrl_init`` must be batched per env (use
        :func:`broadcast_ctrl_state` for shared scalar state)."""

        def body(carry, _):
            state, ctrl_state, prev = carry
            ctrl_state, action = jax.vmap(ctrl_fn)(ctrl_state, prev)
            state, res, carry_res = jax.vmap(step1)(params, state, action)
            # the controller's next invocation sees the reset observation
            # after a done (autoreset_step carry semantics); the trajectory
            # records the terminal result.
            return (state, ctrl_state, carry_res), res

        def chunk(carry, _):
            state, ctrl_state, prev = carry
            # chunk boundary: catch the scenario up to the wall clock and
            # draw this chunk's fresh-episode candidates
            if cfg.scenario_mode == "random":
                from simglucose_tpu.scenario.meal import scenario_regen_now

                dtype = state.patient.x.dtype
                scen = jax.vmap(
                    lambda s, t: scenario_regen_now(s, t, dtype=dtype)
                )(state.scenario, state.patient.t)
                state = state._replace(scenario=scen)
            # C independent candidates (salt=None preserves the single-
            # candidate stream for the first adoption): a lane terminating a
            # second time within the chunk gets a DIFFERENT fresh episode
            # instead of replaying the first candidate.
            C = 2
            drawn = [
                jax.vmap(
                    partial(make_reset_candidates, cfg, salt=None if j == 0 else j)
                )(params, state)
                for j in range(C)
            ]
            cand = jax.tree.map(lambda *xs: jnp.stack(xs), *[c for c, _ in drawn])
            cand_res = jax.tree.map(
                lambda *xs: jnp.stack(xs), *[r for _, r in drawn]
            )
            B = jax.tree.leaves(state)[0].shape[0]
            n_adopt = jnp.zeros((B,), jnp.int32)

            def inner(c2, _):
                state, ctrl_state, prev, n_adopt = c2
                ctrl_state, action = jax.vmap(ctrl_fn)(ctrl_state, prev)
                state, res, carry_res, n_adopt = jax.vmap(
                    stepK, in_axes=(0, 0, 0, 1, 1, 0)
                )(params, state, action, cand, cand_res, n_adopt)
                return (state, ctrl_state, carry_res, n_adopt), res

            (state, ctrl_state, last, _), traj = jax.lax.scan(
                inner, (state, ctrl_state, prev, n_adopt), None, length=K
            )
            return (state, ctrl_state, last), traj

        if K == 1:
            (state, ctrl_state, last), traj = jax.lax.scan(
                body, (state, ctrl_init, prev_res), None, length=n_steps
            )
        else:
            (state, ctrl_state, last), traj = jax.lax.scan(
                chunk, (state, ctrl_init, prev_res), None, length=n_steps // K
            )
            traj = jax.tree.map(
                lambda a: a.reshape((n_steps,) + a.shape[2:]), traj
            )
        # state and last share values (e.g. .done) — without a barrier XLA
        # CSEs them into ONE output buffer, and feeding both back into the
        # next donated call trips "buffer was previously donated" (the
        # f(donate(a), a) hazard).  The barrier forces distinct buffers.
        state, last = jax.lax.optimization_barrier((state, last))
        return state, last, traj

    return jax.jit(run, donate_argnums=(1,) if donate else ())


def make_batch_continue_fn(
    cfg: EnvConfig,
    ctrl_fn: ControllerFn,
    n_steps: int,
    reward_fun=risk_diff_reward,
):
    """Compiled batched continuation WITHOUT auto-reset: steps existing
    episodes onward (the reference's SimObj loop keeps integrating past
    termination too, sim_engine.py:33-37).  Used for chunked rollouts —
    live animation, bounded-compile multi-day sims.

    ``ctrl_state`` must be batched per env (use :func:`broadcast_ctrl_state`
    for shared state).  Returns run(params[B], state[B], ctrl_state[B],
    prev_res[B]) -> (state, ctrl_state, last, traj[T, B]).
    """
    step1 = partial(env_step, cfg, reward_fun=reward_fun)

    def run(params, state: EnvState, ctrl_state, prev_res: StepResult):
        def body(carry, _):
            state, ctrl_state, prev = carry
            ctrl_state, action = jax.vmap(ctrl_fn)(ctrl_state, prev)
            state, res = jax.vmap(step1)(params, state, action)
            return (state, ctrl_state, res), res

        (state, ctrl_state, last), traj = jax.lax.scan(
            body, (state, ctrl_state, prev_res), None, length=n_steps
        )
        state, last = jax.lax.optimization_barrier((state, last))
        return state, ctrl_state, last, traj

    return jax.jit(run)


def broadcast_ctrl_state(ctrl_init, batch: int):
    """Tile a single-env controller state across a batch of ``batch`` envs."""
    return jax.tree.map(
        lambda a: jnp.broadcast_to(jnp.asarray(a), (batch,) + jnp.shape(a)),
        ctrl_init,
    )


def batch_reset(cfg: EnvConfig, params: EnvParams, keys: jax.Array, start_min=None):
    """vmapped env_reset.  ``keys`` is [B]; params leaves carry [B]."""
    B = keys.shape[0]
    if start_min is None:
        hours = jax.vmap(lambda k: jax.random.randint(k, (), 0, 24))(
            jax.vmap(lambda k: jax.random.fold_in(k, 7))(keys)
        )
        start_min = hours * 60
    else:
        start_min = jnp.broadcast_to(jnp.asarray(start_min, jnp.int32), (B,))
    state, res = jax.vmap(lambda p, k, sm: env_reset(cfg, p, k, start_min=sm))(
        params, keys, start_min
    )
    # Distinct buffers for state vs res (see make_batch_rollout_fn): the
    # reset state is typically fed to a donated rollout alongside res.
    return jax.lax.optimization_barrier((state, res))
