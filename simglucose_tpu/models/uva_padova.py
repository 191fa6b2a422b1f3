"""UVA/Padova 2008 glucose-insulin kinetics as batched JAX functions.

The 13-state ODE right-hand side below implements the same physiology as the
reference's ``T1DPatient.model`` (reference: patient/t1dpatient.py:118-208),
re-derived as fully-vectorized, branchless ``jnp`` math:

  * the ``Dbar > 0`` gastric-emptying branch (t1dpatient.py:135-142) and the
    renal-excretion threshold (:158-161) become ``jnp.where`` selects;
  * the non-negativity gates ``(x >= 0) * dxdt`` (:167,173,179,191,195,198,202)
    are already elementwise and stay as multiplicative masks;
  * everything broadcasts over an arbitrary leading batch shape, so one
    compiled kernel serves a single patient or a sharded 32K-patient cohort.

State vector x (mirroring the reference's indices 0..12):
  x0  stomach solid glucose (mg)        x1  stomach liquid glucose (mg)
  x2  gut glucose (mg)                  x3  plasma glucose Gp (mg/kg)
  x4  tissue glucose Gt (mg/kg)         x5  plasma insulin Ip (pmol/kg)
  x6  insulin action X (pmol/L)         x7  delayed insulin action I'
  x8  delayed insulin action Xd         x9  liver insulin Il (pmol/kg)
  x10 subcut insulin solid Isc1         x11 subcut insulin liquid Isc2
  x12 subcutaneous glucose Gs (mg/kg)

Integration: the reference integrates each 1-minute interval with scipy's
adaptive dopri5 (t1dpatient.py:276).  Here the minute is integrated with a
fixed-step Dormand-Prince RK45 (or classic RK4) under ``lax.scan`` — static
shapes, no data-dependent control flow, so XLA compiles one tight fused loop.
Substep count is a static config knob; 1-2 RK45 substeps/min reproduce the
reference trace to ~1e-9 relative (dynamics time constants are >= minutes).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from simglucose_tpu.core.types import PatientParams

# Simulation constants (reference: t1dpatient.py:19-20)
SAMPLE_TIME = 1  # min — patient internal step
EAT_RATE = 5.0  # g/min CHO


def model_rhs(
    x: jnp.ndarray,
    params: PatientParams,
    d_mg: jnp.ndarray,
    insulin_rate: jnp.ndarray,
    Dbar: jnp.ndarray,
) -> jnp.ndarray:
    """Time-derivative of the 13-state system.

    Args:
      x: ``[..., 13]`` state.
      params: patient parameters broadcastable against ``x[..., 0]``.
      d_mg: carbohydrate input in mg/min (reference CHO g/min * 1000).
      insulin_rate: subcutaneous insulin infusion in pmol/kg/min
        (reference U/min * 6000 / BW, conversion done by the caller).
      Dbar: total glucose mass of the ongoing meal in mg
        (last_Qsto + last_foodtaken * 1000, t1dpatient.py:130).

    Returns ``dx/dt`` with the same shape as ``x``.  Autonomous in t (the
    reference RHS ignores its ``t`` argument).
    """
    dxs = model_rhs_parts(
        tuple(x[..., i] for i in range(13)), params, d_mg, insulin_rate, Dbar
    )
    return jnp.stack(dxs, axis=-1)


def model_rhs_parts(
    xs: tuple,
    params: PatientParams,
    d_mg: jnp.ndarray,
    insulin_rate: jnp.ndarray,
    Dbar: jnp.ndarray,
) -> tuple:
    """The RHS on a TUPLE of 13 per-state arrays.

    This form is layout-agnostic: the env path stacks states on a trailing
    axis ([..., 13]), while the rollout kernel keeps each state as its own
    [block] vector, one patient per lane.  Single source of truth for the
    physiology.
    """
    p = params
    x0, x1, x2, x3, x4, x5, x6, x7, x8, x9, x10, x11, x12 = xs

    qsto = x0 + x1

    # Gastric emptying rate: tanh-interpolated between kmin and kmax while a
    # meal is in transit, kmax otherwise (t1dpatient.py:135-142).  Guard the
    # 1/Dbar against the Dbar == 0 branch being selected away.
    safe_Dbar = jnp.where(Dbar > 0, Dbar, 1.0)
    aa = 5.0 / 2.0 / (1.0 - p.b) / safe_Dbar
    cc = 5.0 / 2.0 / p.d / safe_Dbar
    kgut_meal = p.kmin + (p.kmax - p.kmin) / 2.0 * (
        jnp.tanh(aa * (qsto - p.b * safe_Dbar))
        - jnp.tanh(cc * (qsto - p.d * safe_Dbar))
        + 2.0
    )
    kgut = jnp.where(Dbar > 0, kgut_meal, p.kmax)

    # Stomach / intestine (t1dpatient.py:133,145,148)
    dx0 = -p.kmax * x0 + d_mg
    dx1 = p.kmax * x0 - x1 * kgut
    dx2 = kgut * x1 - p.kabs * x2

    # Rate of appearance, endogenous production, utilization (:151-155)
    Rat = p.f * p.kabs * x2 / p.BW
    EGPt = p.kp1 - p.kp2 * x3 - p.kp3 * x8
    Uiit = p.Fsnc

    # Renal excretion threshold (:158-161)
    Et = jnp.where(x3 > p.ke2, p.ke1 * (x3 - p.ke2), 0.0)

    # Plasma glucose kinetics (:163-167)
    dx3 = jnp.maximum(EGPt, 0.0) + Rat - Uiit - Et - p.k1 * x3 + p.k2 * x4
    dx3 = jnp.where(x3 >= 0, dx3, 0.0)

    # Tissue glucose utilization (:169-173)
    Vmt = p.Vm0 + p.Vmx * x6
    Uidt = Vmt * x4 / (p.Km0 + x4)
    dx4 = -Uidt + p.k1 * x3 - p.k2 * x4
    dx4 = jnp.where(x4 >= 0, dx4, 0.0)

    # Plasma insulin kinetics (:176-179)
    dx5 = -(p.m2 + p.m4) * x5 + p.m1 * x9 + p.ka1 * x10 + p.ka2 * x11
    It = x5 / p.Vi
    dx5 = jnp.where(x5 >= 0, dx5, 0.0)

    # Insulin action compartments (:182-187)
    dx6 = -p.p2u * x6 + p.p2u * (It - p.Ib)
    dx7 = -p.ki * (x7 - It)
    dx8 = -p.ki * (x8 - x7)

    # Liver insulin (:190-191)
    dx9 = -(p.m1 + p.m30) * x9 + p.m2 * x5
    dx9 = jnp.where(x9 >= 0, dx9, 0.0)

    # Subcutaneous insulin (:194-198)
    dx10 = insulin_rate - (p.ka1 + p.kd) * x10
    dx10 = jnp.where(x10 >= 0, dx10, 0.0)
    dx11 = p.kd * x10 - p.ka2 * x11
    dx11 = jnp.where(x11 >= 0, dx11, 0.0)

    # Subcutaneous glucose (:201-202)
    dx12 = -p.ksc * x12 + p.ksc * x3
    dx12 = jnp.where(x12 >= 0, dx12, 0.0)

    return (dx0, dx1, dx2, dx3, dx4, dx5, dx6, dx7, dx8, dx9, dx10, dx11, dx12)


# ---------------------------------------------------------------------------
# Fixed-step integrators (static shapes; XLA-fusable)
# ---------------------------------------------------------------------------

# Dormand-Prince 5(4) coefficients — the same tableau scipy's dopri5 uses,
# applied with a fixed step so the whole rollout stays a static-shape scan.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)


def _axpy(x, a, k):
    """x + a*k over a pytree of state components (a bare array or the
    13-tuple form)."""
    return jax.tree.map(lambda xi, ki: xi + a * ki, x, k)


def rk45_step(f, x, h):
    """One fixed-step Dormand-Prince RK45 step of size ``h`` for autonomous
    f.  ``x`` may be an array or a tuple of per-state arrays (f matching)."""
    ks = []
    for stage in range(7):
        xi = x
        for a, k in zip(_DP_A[stage], ks):
            xi = _axpy(xi, h * a, k)
        ks.append(f(xi))
    out = x
    for b, k in zip(_DP_B, ks):
        if b != 0.0:
            out = _axpy(out, h * b, k)
    return out


def rk4_step(f, x, h):
    """One classic RK4 step of size ``h`` for autonomous f.  ``x`` may be an
    array or a tuple of per-state arrays (f matching)."""
    k1 = f(x)
    k2 = f(_axpy(x, 0.5 * h, k1))
    k3 = f(_axpy(x, 0.5 * h, k2))
    k4 = f(_axpy(x, h, k3))
    ksum = jax.tree.map(
        lambda a, b, c, d: a + 2.0 * b + 2.0 * c + d, k1, k2, k3, k4
    )
    return _axpy(x, h / 6.0, ksum)


_STEPPERS = {"rk45": rk45_step, "rk4": rk4_step}


def integrate_minute(
    x: jnp.ndarray,
    params: PatientParams,
    d_mg: jnp.ndarray,
    insulin_rate: jnp.ndarray,
    Dbar: jnp.ndarray,
    substeps: int = 2,
    method: str = "rk45",
) -> jnp.ndarray:
    """Advance the patient ODE by one minute with inputs held constant.

    Matches the reference contract: ``odesolver.integrate(t + 1)`` with
    f-params (action, Dbar) fixed over the minute (t1dpatient.py:110-113).
    ``substeps``/``method`` are static; the substep loop is unrolled so XLA
    fuses the whole minute into one kernel.

    Stage arithmetic runs on the packed ``[..., 13]`` array: one fused op
    over the packed state instead of 13 small per-component fusions.
    """
    stepper = _STEPPERS[method]
    h = jnp.asarray(1.0 / substeps, dtype=x.dtype)
    f = lambda xx: model_rhs(xx, params, d_mg, insulin_rate, Dbar)
    for _ in range(substeps):
        x = stepper(f, x, h)
    return x


def observe_gsub(x: jnp.ndarray, params: PatientParams) -> jnp.ndarray:
    """Subcutaneous glucose observation Gsub = x12 / Vg in mg/dL
    (reference: t1dpatient.py:210-220)."""
    return x[..., 12] / params.Vg


def basal_rate(params: PatientParams) -> jnp.ndarray:
    """Steady-state basal insulin rate u2ss * BW / 6000 in U/min
    (reference: t1dpatient.py:123, basal_bolus_ctrller.py:64)."""
    return params.u2ss * params.BW / 6000.0
