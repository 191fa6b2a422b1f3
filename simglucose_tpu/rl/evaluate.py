"""Clinical evaluation of glucose controllers on the virtual cohort.

Runs any controller — the clinical therapy baselines (BB, PID) or a trained
RL policy — through the SAME closed-loop cohort rollout (identical seeds,
noise streams, and meal scenarios) and reports the reference's published
per-patient performance statistics: time-in-range percentages, LBGI / HBGI /
risk index, and BG summary stats (the quantities of the reference's
``performance_stats.csv``, reference: analysis/report.py:74-133,
examples/results/2017-12-31_17-46-32/performance_stats.csv:1-2).

This is the harness behind ``examples/eval_ppo.py`` and the CI assertion
that the shipped PPO checkpoint controls glucose at least as well as the
PID baseline (tests/test_ppo_eval.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from simglucose_tpu.analysis.risk import risk_index
from simglucose_tpu.core.types import CtrlAction
from simglucose_tpu.rl.policy import PolicyParams, policy_apply


def policy_controller(
    params: PolicyParams,
    basal: jnp.ndarray,
    action_scale: float = None,
    scale_by_basal: bool = None,
    sample_time: int = 3,
    quest=None,
    bb_target: float = 140.0,
):
    """Adapt a trained Gaussian-MLP policy into a functional controller
    (the deterministic/eval form: the policy MEAN through the decoder the
    params were trained with, no sampling — how a trained policy would
    actually be deployed).  Two decoders (PolicyParams.decoder):
    'sigmoid' — rate = sigmoid(mu) * action_scale [* basal];
    'residual_bb' — rate = bb_cmd * exp(action_scale * tanh(mu)), where
    bb_cmd is the basal-bolus therapy command built from ``basal`` and the
    REQUIRED ``quest=`` CR/CF table (raises without it), with the
    correction threshold at ``bb_target``.

    Returns the ``(ctrl_init, ctrl_fn, in_axes)`` triple every rollout
    engine accepts (controllers/functional.py, sim/engine.py
    ``_resolve_controller``), so RL policies drop into ``simulate()``,
    ``rollout_batch``, and the gym wrappers exactly like BB/PID — the
    reference's custom-controller extension point
    (reference: controller/base.py:6-34,
    examples/apply_customized_controller.py).

    ``basal`` (per-patient U/min, ``u2ss*BW/6000`` — the BB therapy basal,
    reference basal_bolus_ctrller.py:64) feeds the featurizer's
    patient-identity / insulin-normalization inputs, and — with
    ``scale_by_basal`` — scales the emitted rate to
    ``sigmoid(mu) * action_scale * basal``, so one policy output means the
    same therapy intensity across the ~6x basal span of the cohort.

    ``action_scale``/``scale_by_basal`` default to the decoder the params
    were TRAINED with (PolicyParams static metadata) — a checkpoint cannot
    silently deploy at a different action parameterization.  Override only
    to deliberately re-scale a policy.

    The controller state carries the observation memory behind the trend
    and insulin-on-board features (rl/policy.py featurize_parts): the
    previous CGM sample (sentinel -1 before the first call -> zero trend)
    and the IOB accumulator, updated each call from ``result.insulin`` —
    the pump-quantized dose the env actually DELIVERED for the previous
    command, the same recurrence the pallas 'nn' kernel runs in-kernel.
    ``sample_time`` must match the env's (Dexcom default 3 min)."""
    from simglucose_tpu.rl.policy import featurize_parts, iob_step

    if action_scale is None:
        action_scale = float(params.action_scale)
    if scale_by_basal is None:
        scale_by_basal = bool(params.scale_by_basal)
    decoder = getattr(params, "decoder", "sigmoid")
    b_arr = jnp.asarray(basal)
    if decoder == "residual_bb":
        # the policy MODULATES basal-bolus therapy (PolicyParams.decoder
        # docs): rate = bb_cmd * exp(scale * tanh(mu)) with bb_cmd the
        # per-patient basal + announced-meal/correction bolus — needs the
        # Quest CR/CF table (reference basal_bolus_ctrller.py:34-80)
        if quest is None:
            raise ValueError(
                "decoder='residual_bb' params need quest= (per-patient "
                "CR/CF arrays, e.g. load_quest_params(names))"
            )
        cr = jnp.asarray(quest.CR)
        cf = jnp.asarray(quest.CF)
    else:
        cr = cf = jnp.zeros_like(b_arr)  # unused carry placeholder

    def policy(state, result):
        b_u, cr_u, cf_u, cgm_prev, iob = state
        cgm = result.observation.CGM
        prev = jnp.where(cgm_prev < 0, cgm, cgm_prev)
        iob = iob_step(iob, result.insulin, sample_time)
        obs = featurize_parts(
            cgm, result.insulin, result.CHO, prev, iob, b_u
        )
        mu, _, _ = policy_apply(params, obs)
        if decoder == "residual_bb":
            meal_ann = result.CHO
            bolus_u = (meal_ann * sample_time) / cr_u + (
                cgm > 150.0
            ).astype(mu.dtype) * (cgm - bb_target) / cf_u
            bolus = jnp.where(meal_ann > 0, bolus_u / sample_time, 0.0)
            rate = (b_u + bolus) * jnp.exp(
                action_scale * jnp.tanh(mu)
            )
        else:
            rate = jax.nn.sigmoid(mu) * action_scale
            if scale_by_basal:
                rate = rate * b_u
        return (b_u, cr_u, cf_u, cgm, iob), CtrlAction(
            basal=rate, bolus=jnp.zeros_like(rate)
        )

    init = (b_arr, cr, cf, -jnp.ones_like(b_arr), jnp.zeros_like(b_arr))
    return init, policy, 0


def cohort_stats(bg: np.ndarray) -> dict:
    """Per-patient clinical statistics from a BG matrix [B, T] (mg/dL).

    Matches the reference's report quantities: time-in-zone percentages
    (reference: analysis/report.py:74-92) and whole-trace LBGI/HBGI/RI
    (reference: analysis/risk.py:5-17 with horizon = full trace, the
    performance_stats.csv convention)."""
    bg = np.asarray(bg)
    T = bg.shape[-1]
    LBGI, HBGI, RI = (np.asarray(x) for x in risk_index(jnp.asarray(bg), T))
    return {
        "BG_mean": bg.mean(axis=-1),
        "BG_min": bg.min(axis=-1),
        "BG_max": bg.max(axis=-1),
        "percent_in_70_180": 100.0 * ((bg >= 70) & (bg <= 180)).mean(axis=-1),
        "percent_below_70": 100.0 * (bg < 70).mean(axis=-1),
        "percent_above_180": 100.0 * (bg > 180).mean(axis=-1),
        "percent_below_50": 100.0 * (bg < 50).mean(axis=-1),
        "percent_above_250": 100.0 * (bg > 250).mean(axis=-1),
        "LBGI": LBGI,
        "HBGI": HBGI,
        "risk_index": RI,
    }


def evaluate_controller(
    controller,
    patient_names,
    hours: float = 24.0,
    seed: int = 0,
    sensor: str = "Dexcom",
    start_min: int = 0,
    random_init_bg: bool = False,
    dtype=np.float32,
) -> dict:
    """Closed-loop cohort evaluation of one controller.

    ``controller``: anything :func:`simglucose_tpu.sim.engine.simulate`
    accepts — 'BB', 'PID', ('PID', {...}), or an ``(init, fn)`` pair such
    as :func:`policy_controller`'s output.

    Fixed-horizon, no auto-reset (the reference's batch_sim protocol,
    reference: simulation/sim_engine.py:29-39): excursions beyond the done
    thresholds stay in the trace and show up in the statistics, exactly as
    in the published cohort results.

    Returns ``cohort_stats`` plus ``names``, ``BG``/``CGM`` traces [B, T],
    and mean insulin.  Two controllers evaluated at the same ``seed`` see
    IDENTICAL noise and meal scenario streams (same threefry key tree) —
    the comparison is paired, like the reference's fixed-seed batch runs.
    """
    from simglucose_tpu.envs.build import make_env
    from simglucose_tpu.envs.rollout import rollout_batch
    from simglucose_tpu.sim.engine import _resolve_controller

    if isinstance(patient_names, str):
        patient_names = [patient_names]
    patient_names = list(patient_names)
    B = len(patient_names)
    cfg, env_params = make_env(
        patient_names,
        sensor=sensor,
        batch=True,
        dtype=dtype,
        random_init_bg=random_init_bg,
    )
    ctrl_init, ctrl_fn, ctrl_axes = _resolve_controller(
        controller, cfg, env_params, patient_names, dtype
    )
    n_steps = int(hours * 60) // cfg.sample_time
    keys = jax.random.split(jax.random.PRNGKey(seed), B)

    run = jax.jit(
        lambda p, k, ci: rollout_batch(
            cfg, p, k, ci, ctrl_fn, n_steps,
            start_min=start_min, ctrl_in_axes=ctrl_axes,
            # the streaming noise/meal path (pregen is bit-identical)
            pregen=False,
        )
    )
    _, reset_res, traj = run(env_params, keys, ctrl_init)
    bg = np.asarray(traj.BG)  # [B, T]
    out = cohort_stats(bg)
    out["names"] = patient_names
    out["BG"] = bg
    out["CGM"] = np.asarray(traj.observation.CGM)
    out["insulin_mean"] = np.asarray(traj.insulin).mean(axis=-1)
    return out


def evaluate_policy_kernel(
    params: PolicyParams,
    patient_names,
    hours: float = 24.0,
    seed: int = 0,
    sensor: str = "Dexcom",
    start_min: int = 0,
    random_init_bg: bool = False,
    interpret: bool = False,
    shard: bool = True,
) -> dict:
    """Large-cohort policy evaluation ON THE PALLAS KERNEL: the XLA harness
    is fine at 30 patients, but a 4096-patient check of the PID-vs-PPO
    comparison deserves the kernel path.

    Runs the 'nn' kernel with ``nn_sample_actions=False`` — policy-MEAN
    actions (exactly :func:`policy_controller`'s deployment law) while the
    env stays stochastic — fixed horizon, no auto-reset (the reference's
    batch_sim protocol, sim_engine.py:29-39).  Same return shape as
    :func:`evaluate_controller`.  Seed reproducibility is law-level (the
    kernel's counter-based generator, not threefry); pair PPO-vs-PID
    comparisons by running both through kernel engines at the same seed.

    Needs a GPU, or ``interpret=True`` (the Pallas interpreter); raises
    on other backends rather than silently interpreting.  The trunk must
    be relu (the kernel's MLP); pack_policy_weights raises otherwise."""
    from simglucose_tpu.envs.build import make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.backend import XLA, kernel_mode
    from simglucose_tpu.ops.pallas_rollout import (
        config_for_sensor,
        make_pallas_rollout,
        make_sharded_pallas_rollout,
        pack_params,
        pack_policy_weights,
    )
    from simglucose_tpu.params import load_quest_params

    if kernel_mode(interpret) == XLA:
        raise ValueError(
            f"evaluate_policy_kernel needs a compiled kernel (a GPU); "
            f"backend {jax.default_backend()!r} has none — pass "
            "interpret=True or use evaluate_controller"
        )
    if isinstance(patient_names, str):
        patient_names = [patient_names]
    patient_names = list(patient_names)
    B = len(patient_names)
    # shard=False keeps the kernel single-device (e.g. interpret-mode CI,
    # where an 8-way shard_map multiplies the Python-interpret cost)
    n_dev = jax.device_count() if shard else 1
    padded = -(-B // n_dev) * n_dev
    names_p = [patient_names[i % B] for i in range(padded)]
    n_steps = int(hours * 60) // int(config_for_sensor(sensor).sample_time)

    _, env_params = make_env(names_p, sensor=sensor, batch=True,
                             dtype=np.float32)
    # quest planes feed the residual_bb decoder's in-kernel BB command;
    # sigmoid configs ignore them
    quest = load_quest_params(names_p, dtype=np.float32)
    packed = pack_params(env_params.patient, basal_rate(env_params.patient),
                         quest=quest)
    cfg = config_for_sensor(
        sensor,
        n_steps=n_steps,
        controller="nn",
        nn_hidden=params.w1.shape[1],
        nn_action_scale=float(params.action_scale),
        nn_scale_by_basal=bool(params.scale_by_basal),
        nn_decoder=getattr(params, "decoder", "sigmoid"),
        nn_sample_actions=False,
        autoreset=False,
        random_init_bg=random_init_bg,
        fixed_start_min=start_min,
    )
    weights = pack_policy_weights(params)
    if n_dev > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from simglucose_tpu.parallel.sharding import make_mesh

        mesh = make_mesh(dp=n_dev, tp=1)
        packed = jax.device_put(packed, NamedSharding(mesh, P(None, "dp")))
        run = make_sharded_pallas_rollout(cfg, padded, mesh, interpret=interpret)
    else:
        run = make_pallas_rollout(cfg, padded, interpret=interpret)
    traj = jax.jit(lambda p, w: run(p, seed, weights=w))(packed, weights)
    bg = np.asarray(traj["BG"]).T[:B]  # [B, T]
    out = cohort_stats(bg)
    out["names"] = patient_names
    out["BG"] = bg
    out["CGM"] = np.asarray(traj["CGM"]).T[:B]
    out["insulin_mean"] = np.asarray(traj["insulin"]).T[:B].mean(axis=-1)
    return out


def stats_frame(results: dict):
    """Per-patient stats dict -> pandas DataFrame (reference
    performance_stats.csv shape; import-light: pandas only here)."""
    import pandas as pd

    cols = {
        k: v
        for k, v in results.items()
        if isinstance(v, np.ndarray) and v.ndim == 1
    }
    return pd.DataFrame(cols, index=results["names"])
