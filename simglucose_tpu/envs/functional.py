"""The closed-loop T1D environment as pure functions over pytree state.

Functional re-design of the reference's ``T1DSimEnv``
(reference: simulation/env.py:36-180):

  * ``mini_step``'s 1-minute inner loop (env.py:48-64) is a statically
    unrolled loop of ``sample_time`` patient/sensor updates — no Python
    state, no data-dependent control flow;
  * the history lists (env.py:88-97) become scan-stacked outputs at the
    rollout layer;
  * the reward's BG-last-hour window (env.py:100-102) is a fixed-size ring
    buffer carried in the state;
  * everything is single-env and gets vmapped over the patient batch, then
    shard_mapped over the device mesh.

Semantics parity notes:
  * CGM sampling: the sensor draws a new sample when the patient clock hits a
    multiple of ``sample_time`` (cgm.py:27) — inside an env step that is the
    last mini-step; other mini-steps reuse the zero-order-hold value.
  * reset draws TWO noise samples: one recorded as history[0]
    (env.py:126-129) and one returned as the reset observation (env.py:142),
    exactly like the reference.
  * step outputs are mini-step averages accumulated in the reference's
    ``acc += v / sample_time`` order (env.py:75-81) for bit-compatible float
    rounding in verification mode.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from simglucose_tpu.analysis.risk import risk_diff_reward, risk_scalar
from simglucose_tpu.core.types import (
    CtrlAction,
    EnvState,
    Observation,
    PatientAction,
    PatientParams,
    PumpParams,
    SensorParams,
    StepResult,
)
from simglucose_tpu.devices.cgm import sensor_init, sensor_sample
from simglucose_tpu.devices.pump import pump_basal, pump_bolus
from simglucose_tpu.models.patient import patient_init, patient_step
from simglucose_tpu.models.uva_padova import observe_gsub
from simglucose_tpu.scenario.meal import (
    custom_meals_for_step,
    scenario_init,
    scenario_lookup_for_step,
    scenario_meals_for_step,
)

RewardFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


def reward_window_size(sample_time: int) -> int:
    """One hour of CGM samples (reference env.py:100) — THE window law;
    ``EnvConfig.window_size`` and the pallas engine's post-hoc reward
    recompute (sim/engine.py) both read it from here."""
    return max(60 // int(sample_time), 2)


def wrap_reward_fn(reward_fun: Callable, window_size: int) -> RewardFn:
    """Adapt a reference-style 1-arg reward over the BG-last-hour history to
    the native ``(window, window_len)`` signature — with EXACT variable-length
    semantics.

    The reference passes ``CGM_hist[-window_size:]`` — a Python list that is
    *shorter* than an hour at episode start (reference: simulation/env.py:
    100-102), so a mean-based reward sees only the real samples.  Under jit
    the window is a fixed-size ring buffer; slicing by the traced
    ``window_len`` is impossible, so the wrapper builds one statically-shaped
    branch per possible history length (``f(window[-L:])`` for L = 1..W) and
    selects with ``lax.switch``.  Each branch traces ``reward_fun`` on a
    static shape, so trace-time Python such as ``len(BG_last_hour) < 2``
    works exactly as it does in the reference.

    Native 2-arg fns pass through untouched.

    Compile-cost contract (measured, CPU, risk-computing reward inside a
    jitted rollout): the W-branch switch at the WORST case — Navigator,
    sample_time=1, W=60 — adds ~1.2s trace + ~0.8s compile over the native
    path, traced ONCE per program (the scan body is traced once, so the
    cost is independent of horizon).  Pinned by
    tests/test_rollout.py::test_wrap_reward_window60_compile_bounded.
    The shape-polymorphic fast path is the native 2-arg signature
    ``(window, window_len)``: it traces exactly once on the full fixed-size
    window with the valid-length supplied — write rewards in that form when
    the W-fold trace matters.
    """
    import inspect

    try:
        n_params = len(inspect.signature(reward_fun).parameters)
    except (TypeError, ValueError):
        n_params = 2
    if n_params >= 2:
        return reward_fun
    W = int(window_size)

    def wrapped(window: jnp.ndarray, window_len: jnp.ndarray) -> jnp.ndarray:
        branches = [
            (lambda L: lambda: jnp.asarray(reward_fun(window[W - L:]), window.dtype))(L)
            for L in range(1, W + 1)
        ]
        idx = jnp.clip(window_len, 1, W) - 1
        return jax.lax.switch(idx, branches)

    return wrapped


def rewards_from_cgm(
    reward_fun: Callable,
    window_size: int,
    cgm0: jnp.ndarray,
    cgm: jnp.ndarray,
) -> jnp.ndarray:
    """Recompute the per-step reward plane from a CGM trajectory, replaying
    ``env_step``'s ring-buffer window law exactly (reference:
    simulation/env.py:100-102 — reward over ``CGM_hist[-window_size:]``).

    ``cgm0`` [B] is the reset history sample (``env_reset``'s CGM_hist0,
    env.py:126-129); ``cgm`` [T, B] the per-step CGM.  Returns [T, B]
    rewards equal to what the env path would have produced for the same
    CGM values — this is how the pallas engine serves arbitrary
    (window-based) ``reward_fun``s: the kernel emits the trajectory planes
    and the reward is one XLA scan over them (the ``rl/fused.py``
    ``reward_fn`` pattern, generalized).  ``reward_fun`` may be native
    2-arg ``(window, window_len)`` or a reference-style 1-arg fn
    (wrapped via :func:`wrap_reward_fn`)."""
    rf = wrap_reward_fn(reward_fun, window_size)
    W = int(window_size)
    B = cgm0.shape[0]
    window = jnp.zeros((W, B), cgm.dtype).at[-1].set(cgm0)
    rf_b = jax.vmap(rf, in_axes=(1, None), out_axes=0)  # [W, B] -> [B]

    def body(carry, cgm_t):
        window, wlen = carry
        window = jnp.concatenate([window[1:], cgm_t[None]], axis=0)
        wlen = jnp.minimum(wlen + 1, W)
        r = rf_b(window, wlen)
        return (window, wlen), r

    _, rewards = jax.lax.scan(body, (window, jnp.int32(1)), cgm)
    return rewards


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration — hashable; changing any field
    triggers a recompile (shapes/scan lengths depend on it)."""

    sample_time: int = 3  # CGM sampling period, min (Dexcom)
    substeps: int = 1  # ODE substeps per minute
    method: str = "rk45"  # 'rk45' | 'rk4'
    noise_mode: str = "native"  # 'native' | 'exogenous' | 'xs'
    scenario_mode: str = "random"  # 'random'|'exogenous'|'custom'|'none'|'xs'
    random_init_bg: bool = False
    bg_done_low: float = 70.0  # episode termination (env.py:103)
    bg_done_high: float = 350.0

    @property
    def window_size(self) -> int:
        """Reward window: one hour of CGM samples (env.py:100)."""
        return reward_window_size(self.sample_time)


class EnvParams(NamedTuple):
    """Per-run parameters and optional exogenous sequences.

    ``noise_seq``/``meal_seq`` feed the bit-exact verification path (host
    MT19937 pregeneration, :mod:`simglucose_tpu.compat`); ``custom_times``/
    ``custom_amounts`` implement CustomScenario (scenario.py:21-45).
    Array leaves are single-env; vmap adds the batch axis.
    """

    patient: PatientParams
    sensor: SensorParams
    pump: PumpParams
    noise_seq: Optional[jnp.ndarray] = None  # [N] noise pops
    meal_seq: Optional[jnp.ndarray] = None  # [M] g per minute-of-episode
    custom_times: Optional[jnp.ndarray] = None  # [K] minutes since start
    custom_amounts: Optional[jnp.ndarray] = None  # [K] g


def _noise_seq(cfg: EnvConfig, params: EnvParams) -> Optional[jnp.ndarray]:
    """``cfg.noise_mode`` is authoritative — error on disagreement with the
    params, never silently fall back to the other noise source."""
    if cfg.noise_mode == "exogenous":
        if params.noise_seq is None:
            raise ValueError(
                "noise_mode='exogenous' requires EnvParams.noise_seq "
                "(host-pregenerated noise values, e.g. compat.reference_cgm_noise)"
            )
        return params.noise_seq
    if cfg.noise_mode == "xs":
        # noise values are fed per step by the rollout scan (exo_noise);
        # nothing to read from params.
        return None
    if cfg.noise_mode != "native":
        raise ValueError(f"unknown noise_mode {cfg.noise_mode!r}")
    if params.noise_seq is not None:
        raise ValueError(
            "noise_mode='native' but EnvParams.noise_seq is set — build the "
            "config with noise_mode='exogenous' (make_env does this when "
            "noise_seq is passed)"
        )
    return None


def env_reset(
    cfg: EnvConfig,
    params: EnvParams,
    key: jax.Array,
    start_min: jnp.ndarray = 0,
    init_state: Optional[jnp.ndarray] = None,
) -> tuple[EnvState, StepResult]:
    """Fresh episode (reference: env.py:119-155).

    ``start_min`` is the episode start time in minutes-of-day (drives the
    scenario's midnight rollovers).  Returns the reset observation exactly
    like the reference's ``reset()`` Step.
    """
    if cfg.noise_mode == "xs":
        # 'xs' is an internal scan-feeding mode (rollout(pregen=True)): noise
        # arrives per step from the scan's xs, but reset needs TWO samples
        # (env.py:126,142) that no scan supplies — resetting under 'xs' would
        # silently mix native reset noise with exogenous step noise.  The
        # pregen path resets under a noise_mode='exogenous' config instead
        # (envs/rollout.py).
        raise ValueError(
            "env_reset does not accept noise_mode='xs' — reset under "
            "noise_mode='exogenous' with the pregenerated plane "
            "(see rollout(pregen=True)) or use 'native'"
        )
    dtype = params.patient.x0.dtype
    k_patient, k_sensor, k_scenario = jax.random.split(key, 3)

    patient = patient_init(
        params.patient,
        key=k_patient,
        random_init_bg=cfg.random_init_bg,
        init_state=init_state,
        dtype=dtype,
    )
    sensor = sensor_init(params.sensor, k_sensor, dtype=dtype)
    scenario = scenario_init(k_scenario, start_min, dtype=dtype)

    BG0 = observe_gsub(patient.x, params.patient)
    LBGI, HBGI, risk = risk_scalar(BG0)

    # Two reset-time sensor samples, like the reference (env.py:126,142).
    noise_seq = _noise_seq(cfg, params)
    sensor, CGM_hist0 = sensor_sample(
        params.sensor, cfg.sample_time, sensor, BG0, noise_seq
    )
    sensor, CGM_obs = sensor_sample(
        params.sensor, cfg.sample_time, sensor, BG0, noise_seq
    )

    W = cfg.window_size
    window = jnp.zeros((W,), dtype=dtype).at[-1].set(CGM_hist0)

    state = EnvState(
        patient=patient,
        sensor=sensor,
        scenario=scenario,
        cgm_window=window,
        window_len=jnp.int32(1),
        done=jnp.asarray(False),
        episode_step=jnp.int32(0),
        key=key,
    )
    zero = jnp.asarray(0.0, dtype)
    result = StepResult(
        observation=Observation(CGM=CGM_obs),
        reward=zero,
        done=jnp.asarray(False),
        CHO=zero,
        insulin=zero,
        BG=BG0,
        CGM=CGM_hist0,
        LBGI=LBGI,
        HBGI=HBGI,
        risk=risk,
    )
    return state, result


def env_step(
    cfg: EnvConfig,
    params: EnvParams,
    state: EnvState,
    action: CtrlAction,
    reward_fun: RewardFn = risk_diff_reward,
    exo_meals: Optional[jnp.ndarray] = None,
    exo_noise: Optional[jnp.ndarray] = None,
    scenario_regen: bool = True,
) -> tuple[EnvState, StepResult]:
    """One env step = ``sample_time`` mini-steps (reference: env.py:66-117).

    ``exo_meals`` ([sample_time] g/min) / ``exo_noise`` (scalar) feed the
    'xs' modes: the rollout scan supplies each step's stream values directly
    so no per-lane gather is emitted (envs/rollout.py ``pregen``).

    ``scenario_regen=False`` (static) skips the candidate next-day plan draw
    in 'random' mode — the cadenced engines hoist the midnight regeneration
    to chunk boundaries, which is trajectory-exact as long as the chunk is
    shorter than the 5h meal-free window after midnight (all meal slots are
    truncated to [05:00, 23:00], scenario/meal.py TIME_LB/TIME_UB;
    reference scenario_gen.py:36-44).
    """
    dtype = state.patient.x.dtype
    st = cfg.sample_time
    p = params.patient

    # Pump quantization is identical for every mini-step (env.py:51-52) —
    # hoisted out of the loop.
    basal = pump_basal(params.pump, jnp.asarray(action.basal, dtype))
    bolus = pump_bolus(params.pump, jnp.asarray(action.bolus, dtype))
    insulin_rate = basal + bolus

    t0 = state.patient.t
    scenario = state.scenario
    if cfg.scenario_mode == "random":
        if scenario_regen:
            scenario, meals = scenario_meals_for_step(
                scenario, t0, st, dtype=dtype
            )
        else:
            meals = scenario_lookup_for_step(scenario, t0, st)
    elif cfg.scenario_mode == "xs":
        if exo_meals is None:
            raise ValueError("scenario_mode='xs' requires exo_meals")
        meals = exo_meals
    elif cfg.scenario_mode == "exogenous":
        meals = jax.lax.dynamic_slice(params.meal_seq, (t0,), (st,))
    elif cfg.scenario_mode == "custom":
        meals = custom_meals_for_step(params.custom_times, params.custom_amounts, t0, st)
    elif cfg.scenario_mode == "none":
        meals = jnp.zeros((st,), dtype)
    else:
        raise ValueError(f"unknown scenario_mode {cfg.scenario_mode!r}")

    patient = state.patient
    sensor = state.sensor
    noise_seq = _noise_seq(cfg, params)
    fst = float(st)
    CHO_avg = jnp.asarray(0.0, dtype)
    ins_avg = jnp.asarray(0.0, dtype)
    BG_avg = jnp.asarray(0.0, dtype)
    CGM_avg = jnp.asarray(0.0, dtype)

    for i in range(st):
        patient = patient_step(
            patient,
            p,
            PatientAction(CHO=meals[i], insulin=insulin_rate),
            substeps=cfg.substeps,
            method=cfg.method,
        )
        BG_i = observe_gsub(patient.x, p)
        if i == st - 1:
            # patient clock hits a multiple of sample_time -> fresh sample
            if cfg.noise_mode == "xs":
                if exo_noise is None:
                    raise ValueError("noise_mode='xs' requires exo_noise")
                sensor, CGM_i = sensor_sample(
                    params.sensor, st, sensor, BG_i, noise_value=exo_noise
                )
            else:
                sensor, CGM_i = sensor_sample(
                    params.sensor, st, sensor, BG_i, noise_seq
                )
        else:
            CGM_i = sensor.last_CGM  # zero-order hold (cgm.py:35-36)
        # accumulate with the reference's exact op order (env.py:77-81):
        # acc += v / sample_time (division, not reciprocal-multiply, for
        # bit-compatible rounding in verification mode)
        CHO_avg = CHO_avg + meals[i] / fst
        ins_avg = ins_avg + insulin_rate / fst
        BG_avg = BG_avg + BG_i / fst
        CGM_avg = CGM_avg + CGM_i / fst

    LBGI, HBGI, risk = risk_scalar(BG_avg)

    window = jnp.concatenate([state.cgm_window[1:], CGM_avg[None]])
    window_len = jnp.minimum(state.window_len + 1, cfg.window_size)
    reward = reward_fun(window, window_len)
    done = (BG_avg < cfg.bg_done_low) | (BG_avg > cfg.bg_done_high)

    new_state = EnvState(
        patient=patient,
        sensor=sensor,
        scenario=scenario,
        cgm_window=window,
        window_len=window_len,
        done=done,
        episode_step=state.episode_step + 1,
        key=state.key,
    )
    result = StepResult(
        observation=Observation(CGM=CGM_avg),
        reward=reward,
        done=done,
        CHO=CHO_avg,
        insulin=ins_avg,
        BG=BG_avg,
        CGM=CGM_avg,
        LBGI=LBGI,
        HBGI=HBGI,
        risk=risk,
    )
    return new_state, result
