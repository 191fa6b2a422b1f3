"""Evaluate the shipped PPO glucose-control policy against the clinical
therapy baselines (basal-bolus and PID) on the full 30-patient cohort.

All three controllers run through the SAME closed-loop cohort rollout —
identical seeds, CGM noise streams, and meal scenarios — and are compared
on the reference's published performance statistics: time-in-range
percentages and LBGI/HBGI/risk index per patient
(reference: examples/results/2017-12-31_17-46-32/performance_stats.csv,
analysis/report.py:74-133).

The policy checkpoint was trained by tools/train_ppo_cohort.py (fused PPO,
the in-kernel actor at B=8192); it is loaded in its
deterministic deployment form (mean action, no exploration noise) via
rl/evaluate.policy_controller — an ordinary functional controller that
also drops into simulate() and the gym wrappers.

Run: python examples/eval_ppo.py [hours] [seed]
"""
import os
import sys

import jax
import numpy as np

from simglucose_tpu import params as tables
from simglucose_tpu.rl.evaluate import (
    evaluate_controller,
    policy_controller,
    stats_frame,
)
from simglucose_tpu.rl.policy import init_policy
from simglucose_tpu.utils.checkpoint import restore_state

CKPT = os.path.join(
    os.path.dirname(__file__), "checkpoints", "ppo_cohort_relu64.npz"
)
RESIDUAL_CKPT = os.path.join(
    os.path.dirname(__file__), "checkpoints", "ppo_cohort_residual_bb.npz"
)

hours = float(sys.argv[1]) if len(sys.argv) > 1 else 24.0
seed = int(sys.argv[2]) if len(sys.argv) > 2 else 1234

# the static metadata states the decoder the checkpoint was TRAINED with
# (tools/train_ppo_tpu.py: basal-scaled actions, emitted rate =
# sigmoid(mu) * action_scale * patient_basal); policy_controller reads it
# from the params, so the deploy form cannot drift from training
like = init_policy(
    jax.random.PRNGKey(0), hidden=64, act="relu",
    action_scale=10.0, scale_by_basal=True,
)
policy = restore_state(CKPT, like=like)

names = tables.patient_names()
from simglucose_tpu.models.uva_padova import basal_rate  # noqa: E402

basal = basal_rate(tables.load_patient_params(names, dtype=np.float32))
quest = tables.load_quest_params(names, dtype=np.float32)
# the residual_bb checkpoint MODULATES basal-bolus therapy
# (PolicyParams.decoder docs) — the BB-competitive flagship policy
residual = restore_state(
    RESIDUAL_CKPT,
    like=init_policy(
        jax.random.PRNGKey(0), hidden=64, act="relu",
        action_scale=1.1, scale_by_basal=False, decoder="residual_bb",
    ),
)
controllers = {
    "PPO residual-BB": policy_controller(residual, basal, quest=quest),
    "PPO (absolute)": policy_controller(policy, basal),
    "BB therapy": "BB",
    "PID": "PID",
}

# At 30 patients the XLA harness is instant; for LARGE cohorts (e.g. a
# 4096-patient confidence interval on the comparison) use the kernel
# engine instead: rl.evaluate.evaluate_policy_kernel(policy, names, ...)
# runs policy-mean actions inside the pallas 'nn' kernel at ~1B steps/s.
summaries = {}
for label, ctrl in controllers.items():
    res = evaluate_controller(ctrl, names, hours=hours, seed=seed)
    df = stats_frame(res)
    summaries[label] = df
    print(f"\n=== {label} — {hours:.0f} h, 30-patient cohort, seed {seed} ===")
    print(df.round(3).to_string())

print("\n=== Cohort means ===")
for label, df in summaries.items():
    print(
        f"{label:22s} RI {df.risk_index.mean():6.3f}  "
        f"LBGI {df.LBGI.mean():5.3f}  HBGI {df.HBGI.mean():6.3f}  "
        f"TIR {df.percent_in_70_180.mean():5.1f}%  "
        f"hypo {df.percent_below_70.mean():4.2f}%  "
        f"BG {df.BG_mean.mean():5.1f}"
    )

res_ri = summaries["PPO residual-BB"].risk_index.mean()
bb_ri = summaries["BB therapy"].risk_index.mean()
ppo_ri = summaries["PPO (absolute)"].risk_index.mean()
pid_ri = summaries["PID"].risk_index.mean()
print(
    f"\nPPO residual-BB mean risk index {res_ri:.3f} vs BB {bb_ri:.3f} "
    f"({'BEATS' if res_ri < bb_ri else 'does not beat'} the BB baseline); "
    f"absolute-decoder PPO {ppo_ri:.3f} vs PID {pid_ri:.3f} "
    f"({'BEATS' if ppo_ri < pid_ri else 'does not beat'} PID)"
)
