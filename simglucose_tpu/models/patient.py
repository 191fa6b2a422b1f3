"""Functional T1D patient: meal state machine + one-minute ODE advance.

This is the functional replacement for the reference's stateful
``T1DPatient.step`` (reference: patient/t1dpatient.py:82-116) and
``_announce_meal`` (:222-236).  The eating state machine becomes branchless
``jnp.where`` updates over explicit :class:`PatientState` pytrees, so it
vmaps/shards over arbitrary patient batches.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from simglucose_tpu.core.types import PatientAction, PatientParams, PatientState
from simglucose_tpu.models.uva_padova import (
    EAT_RATE,
    basal_rate,
    integrate_minute,
    observe_gsub,
)


def patient_init(
    params: PatientParams,
    key: Optional[jax.Array] = None,
    random_init_bg: bool = False,
    init_state: Optional[jnp.ndarray] = None,
    dtype=jnp.float32,
) -> PatientState:
    """Build the initial patient state (reference: t1dpatient.py:247-281).

    With ``random_init_bg`` the glucose-related states x3, x4, x12 (0-based)
    are perturbed as N(x0_i, 0.1*x0_i) — same marginal law as the reference's
    diagonal multivariate normal (t1dpatient.py:257-270), drawn from
    ``jax.random`` instead of numpy's MT19937.  For bit-exact reference
    randomness use :mod:`simglucose_tpu.compat` and pass ``init_state``.
    """
    x0 = jnp.asarray(params.x0 if init_state is None else init_state, dtype=dtype)
    if random_init_bg:
        if key is None:
            raise ValueError("random_init_bg=True requires a PRNG key")
        z = jax.random.normal(key, x0[..., 0:3].shape, dtype=dtype)
        idx = jnp.asarray([3, 4, 12])
        mean = x0[..., idx]
        std = jnp.sqrt(0.1 * mean)
        x0 = x0.at[..., idx].set(mean + std * z)

    batch = x0.shape[:-1]
    zeros = jnp.zeros(batch, dtype=dtype)
    return PatientState(
        x=x0,
        planned_meal=zeros,
        last_CHO=zeros,
        is_eating=jnp.zeros(batch, dtype=bool),
        # reference seeds last_Qsto from the initial stomach content
        # (t1dpatient.py:272)
        last_Qsto=x0[..., 0] + x0[..., 1],
        last_foodtaken=zeros,
        t=jnp.zeros(batch, dtype=jnp.int32),
    )


def announce_meal(
    planned_meal: jnp.ndarray, new_CHO: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Queue announced CHO and release it at EAT_RATE g/min
    (reference: t1dpatient.py:222-236).  Returns (to_eat, remaining_queue)."""
    planned = planned_meal + new_CHO
    to_eat = jnp.where(planned > 0, jnp.minimum(EAT_RATE, planned), 0.0)
    planned = jnp.maximum(planned - to_eat, 0.0)
    return to_eat, planned


def patient_step(
    state: PatientState,
    params: PatientParams,
    action: PatientAction,
    substeps: int = 2,
    method: str = "rk45",
) -> PatientState:
    """Advance the patient by one minute (reference: t1dpatient.py:82-116).

    Order of operations mirrors the reference exactly:
      1. meal announcement -> to_eat (queue drained at EAT_RATE);
      2. eating-start detection snapshots last_Qsto and zeroes last_foodtaken;
      3. while eating, last_foodtaken accumulates to_eat;
      4. eating-end detection (after accumulation);
      5. ODE advance with inputs held constant for the minute.
    """
    to_eat, planned = announce_meal(state.planned_meal, action.CHO)

    starts = (to_eat > 0) & (state.last_CHO <= 0)
    qsto_now = state.x[..., 0] + state.x[..., 1]
    last_Qsto = jnp.where(starts, qsto_now, state.last_Qsto)
    foodtaken = jnp.where(starts, 0.0, state.last_foodtaken)
    is_eating = starts | state.is_eating
    foodtaken = jnp.where(is_eating, foodtaken + to_eat, foodtaken)
    ends = (to_eat <= 0) & (state.last_CHO > 0)
    is_eating = is_eating & ~ends

    d_mg = to_eat * 1000.0  # g/min -> mg/min (t1dpatient.py:121)
    insulin_rate = action.insulin * 6000.0 / params.BW  # U/min -> pmol/kg/min
    Dbar = last_Qsto + foodtaken * 1000.0  # mg (t1dpatient.py:130)

    x = integrate_minute(
        state.x, params, d_mg, insulin_rate, Dbar, substeps=substeps, method=method
    )

    return PatientState(
        x=x,
        planned_meal=planned,
        last_CHO=to_eat,
        is_eating=is_eating,
        last_Qsto=last_Qsto,
        last_foodtaken=foodtaken,
        t=state.t + 1,
    )


__all__ = [
    "patient_init",
    "patient_step",
    "announce_meal",
    "observe_gsub",
    "basal_rate",
]


def _demo():  # pragma: no cover
    """Open-loop demo — the patient layer with zero framework above it
    (reference: t1dpatient.py:284-323): constant basal, 80 g meal + bolus at
    t=100 min, 1000 minutes, plotted."""
    import numpy as np

    from simglucose_tpu.params import load_patient_params

    params = jax.tree.map(
        lambda a: jnp.asarray(a[0]), load_patient_params("adolescent#001")
    )
    basal = float(basal_rate(params))
    state = patient_init(params)

    def minute(state, t):
        ins = jnp.where(t == 100, 80.0 / 6.0 + basal, basal)
        cho = jnp.where(t == 100, 80.0, 0.0)
        state = patient_step(state, params, PatientAction(CHO=cho, insulin=ins))
        return state, observe_gsub(state.x, params)

    _, bg = jax.lax.scan(minute, state, jnp.arange(1000))
    bg = np.asarray(bg)
    print(f"BG: start={bg[0]:.1f} peak={bg.max():.1f} end={bg[-1]:.1f} mg/dL")
    try:
        import matplotlib.pyplot as plt

        plt.plot(bg)
        plt.xlabel("t (min)")
        plt.ylabel("BG (mg/dL)")
        plt.title("adolescent#001 open loop, 80 g meal @ t=100")
        plt.show()
    except Exception:
        pass


if __name__ == "__main__":  # pragma: no cover
    _demo()
