"""Core pytree types for the simglucose framework.

Everything in this framework is a pure function over explicit pytree state.
These NamedTuples are the state/parameter schemas.  All array fields carry a
leading batch dimension ``[B]`` when used in the batched (vmapped/sharded)
path, or are scalars/1-D in the single-patient path — the kernels are written
shape-polymorphically.

Reference parity notes cite the upstream simglucose source as file:line.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Parameters (static per run; arrays batched over patients)
# ---------------------------------------------------------------------------


class PatientParams(NamedTuple):
    """UVA/Padova kinetic parameters for a (batch of) virtual patient(s).

    Mirrors the columns of the reference's vpatient_params table consumed by
    the ODE right-hand side (reference: patient/t1dpatient.py:118-208) plus
    the initial state vector x0 (columns x0_1..x0_13).
    """

    x0: jnp.ndarray  # [..., 13] initial state
    BW: jnp.ndarray
    EGPb: jnp.ndarray
    Gb: jnp.ndarray
    Ib: jnp.ndarray
    kabs: jnp.ndarray
    kmax: jnp.ndarray
    kmin: jnp.ndarray
    b: jnp.ndarray
    d: jnp.ndarray
    Vg: jnp.ndarray
    Vi: jnp.ndarray
    Vmx: jnp.ndarray
    Km0: jnp.ndarray
    k2: jnp.ndarray
    k1: jnp.ndarray
    p2u: jnp.ndarray
    m1: jnp.ndarray
    m2: jnp.ndarray
    m4: jnp.ndarray
    m30: jnp.ndarray
    ki: jnp.ndarray
    kp1: jnp.ndarray
    kp2: jnp.ndarray
    kp3: jnp.ndarray
    f: jnp.ndarray
    ke1: jnp.ndarray
    ke2: jnp.ndarray
    Fsnc: jnp.ndarray
    Vm0: jnp.ndarray
    kd: jnp.ndarray
    ksc: jnp.ndarray
    ka1: jnp.ndarray
    ka2: jnp.ndarray
    u2ss: jnp.ndarray


class QuestParams(NamedTuple):
    """Basal-bolus therapy parameters (reference: params/Quest.csv,
    controller/basal_bolus_ctrller.py:52-62)."""

    CR: jnp.ndarray
    CF: jnp.ndarray
    Age: jnp.ndarray
    TDI: jnp.ndarray


class SensorParams(NamedTuple):
    """CGM sensor hardware parameters (reference: params/sensor_params.csv).

    ``sample_time`` is kept OUT of this pytree — it changes scan lengths and
    must be a static Python int in :class:`simglucose_tpu.envs.EnvConfig`.
    """

    PACF: jnp.ndarray
    gamma: jnp.ndarray
    lam: jnp.ndarray  # the reference calls this "lambda"
    delta: jnp.ndarray
    xi: jnp.ndarray
    min: jnp.ndarray
    max: jnp.ndarray


class PumpParams(NamedTuple):
    """Insulin pump quantization parameters (reference: params/pump_params.csv,
    actuator/pump.py:23-39)."""

    min_bolus: jnp.ndarray
    max_bolus: jnp.ndarray
    inc_bolus: jnp.ndarray
    min_basal: jnp.ndarray
    max_basal: jnp.ndarray
    inc_basal: jnp.ndarray


# ---------------------------------------------------------------------------
# Actions / observations
# ---------------------------------------------------------------------------


class PatientAction(NamedTuple):
    """Input to the physiological model (reference: t1dpatient.py:11)."""

    CHO: jnp.ndarray  # g/min carbohydrate delivered this minute
    insulin: jnp.ndarray  # U/min


class CtrlAction(NamedTuple):
    """Controller output (reference: controller/base.py:3)."""

    basal: jnp.ndarray  # U/min
    bolus: jnp.ndarray  # U/min


class Observation(NamedTuple):
    """Environment observation (reference: simulation/env.py:23)."""

    CGM: jnp.ndarray  # mg/dL


# ---------------------------------------------------------------------------
# State pytrees
# ---------------------------------------------------------------------------


class PatientState(NamedTuple):
    """Full state of the 13-ODE UVA/Padova patient plus the meal
    announcement/eating bookkeeping (reference: t1dpatient.py:70-107,222-236,
    272-281)."""

    x: jnp.ndarray  # [..., 13] ODE state
    planned_meal: jnp.ndarray  # g still queued to be eaten at EAT_RATE
    last_CHO: jnp.ndarray  # g/min actually eaten in the previous minute
    is_eating: jnp.ndarray  # bool
    last_Qsto: jnp.ndarray  # mg, stomach glucose snapshot at meal start
    last_foodtaken: jnp.ndarray  # g eaten in the current meal
    t: jnp.ndarray  # int32 minutes since episode start


class SensorState(NamedTuple):
    """CGM sensor state.

    Native noise path: the reference's AR(1)-at-15-min-lattice + Johnson-SU
    transform + cubic-resample chain (sensor/noise_gen.py:30-56,72-97) is kept
    as a streaming state machine: ``e`` is the raw AR(1) state, ``lattice``
    holds the 4 Johnson-transformed lattice values bracketing the current
    15-min segment, advanced one point at a time.  In precomputed (reference-
    exact) mode only ``last_CGM`` and ``sample_count`` are used — the noise
    values come from a host-pregenerated MT19937-exact array.
    """

    last_CGM: jnp.ndarray
    e: jnp.ndarray  # AR(1) recursion state (pre-Johnson)
    lattice: jnp.ndarray  # [..., 4] Johnson-transformed lattice window
    seg: jnp.ndarray  # int32 current 15-min segment index
    lattice_next: jnp.ndarray  # int32 next lattice point index to draw
    sample_count: jnp.ndarray  # int32, number of CGM samples drawn so far
    key: jnp.ndarray  # jax PRNG key for native noise


class ScenarioState(NamedTuple):
    """Materialized daily meal plan (reference: simulation/scenario_gen.py:33-60).

    ``meal_times`` are minutes-of-day; skipped meals carry time -1 (never
    matches) and amount 0.  ``start_min`` is the episode start time as
    minutes-of-day; ``day`` is the day index the current plan belongs to.
    """

    meal_times: jnp.ndarray  # [..., 6] minute-of-day (float, reference rounds)
    meal_amounts: jnp.ndarray  # [..., 6] g
    day: jnp.ndarray  # int32 day index the plan belongs to
    start_min: jnp.ndarray  # int32 episode start minute-of-day
    key: jnp.ndarray  # jax PRNG key for regeneration


class EnvState(NamedTuple):
    """Carry for one closed-loop environment (batched over patients).

    ``cgm_window`` is the ring buffer backing the reward function's
    BG-last-hour window (reference: simulation/env.py:100-102).
    """

    patient: PatientState
    sensor: SensorState
    scenario: ScenarioState
    cgm_window: jnp.ndarray  # [..., W] last-hour CGM ring buffer
    window_len: jnp.ndarray  # int32 valid entries in cgm_window
    done: jnp.ndarray  # bool, episode terminated
    episode_step: jnp.ndarray  # int32 env steps taken this episode
    key: jnp.ndarray  # per-env PRNG key (for auto-reset re-init)


class StepResult(NamedTuple):
    """Outputs of one env step (reference: simulation/env.py:106-117)."""

    observation: Observation
    reward: jnp.ndarray
    done: jnp.ndarray
    CHO: jnp.ndarray
    insulin: jnp.ndarray
    BG: jnp.ndarray
    CGM: jnp.ndarray
    LBGI: jnp.ndarray
    HBGI: jnp.ndarray
    risk: jnp.ndarray
