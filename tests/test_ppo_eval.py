"""The shipped PPO checkpoint must be clinically competitive: evaluated
deterministically on the 30-patient cohort, its mean risk index must be at
least as good as the PID therapy baseline at the same seeds.

This is the committed proof behind the "trained policy controls glucose"
claim — the analog of the reference's published cohort stats
(reference: examples/results/2017-12-31_17-46-32/performance_stats.csv,
produced by batch_sim + report) applied to the RL policy, with the PID
controller (reference: controller/pid_ctrller.py:8-40) as the bar.

CI scale: 30 patients x 6 h (the full 24 h comparison is run by
examples/eval_ppo.py and recorded in BASELINE.md).
"""
import os

import jax
import numpy as np
import pytest

CKPT = os.path.join(
    os.path.dirname(__file__), "..", "examples", "checkpoints",
    "ppo_cohort_relu64.npz",
)

HOURS = 6.0
SEED = 1234


@pytest.fixture(scope="module")
def trained_policy():
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.utils.checkpoint import restore_state

    if not os.path.exists(CKPT):
        pytest.fail(f"committed checkpoint missing: {CKPT}")
    # the action-decoder metadata must state the decoder the checkpoint was
    # TRAINED with (tools/train_ppo_tpu.py); policy_controller deploys it
    like = init_policy(
        jax.random.PRNGKey(0), hidden=64, act="relu",
        action_scale=10.0, scale_by_basal=True,
    )
    return restore_state(CKPT, like=like)


def test_ppo_checkpoint_beats_pid_baseline(trained_policy):
    import numpy as _np

    from simglucose_tpu import params as tables
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.rl.evaluate import (
        evaluate_controller,
        policy_controller,
    )

    names = tables.patient_names()
    # the checkpoint was trained with basal-scaled actions
    # (tools/train_ppo_tpu.py: nn_scale_by_basal, action_scale=10) — the
    # deploy form must match the training action parameterization
    basal = basal_rate(tables.load_patient_params(names, dtype=_np.float32))
    ppo = evaluate_controller(
        policy_controller(trained_policy, basal),
        names, hours=HOURS, seed=SEED,
    )
    pid = evaluate_controller("PID", names, hours=HOURS, seed=SEED)

    ppo_ri = float(ppo["risk_index"].mean())
    pid_ri = float(pid["risk_index"].mean())
    # paired comparison (identical noise/meal streams at the same seed)
    assert ppo_ri <= pid_ri, (
        f"trained policy mean RI {ppo_ri:.3f} worse than PID {pid_ri:.3f}"
    )
    # and it is actually controlling glucose, not gaming the metric:
    # no hypoglycemia epidemic, and decent time in range
    assert float(ppo["percent_below_50"].mean()) < 1.0
    assert float(ppo["percent_in_70_180"].mean()) > 50.0
    assert np.isfinite(ppo["BG"]).all()


def test_policy_controller_is_deterministic(trained_policy):
    """The eval form is deterministic: same seed -> identical trace."""
    import numpy as _np

    from simglucose_tpu import params as tables
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.rl.evaluate import (
        evaluate_controller,
        policy_controller,
    )

    basal = basal_rate(
        tables.load_patient_params(["adolescent#001"], dtype=_np.float32)
    )
    a = evaluate_controller(
        policy_controller(trained_policy, basal), ["adolescent#001"],
        hours=1.0, seed=3,
    )
    b = evaluate_controller(
        policy_controller(trained_policy, basal), ["adolescent#001"],
        hours=1.0, seed=3,
    )
    np.testing.assert_array_equal(a["BG"], b["BG"])


def test_evaluate_policy_kernel_interpret():
    """Kernel-engine policy evaluation (rl/evaluate.evaluate_policy_kernel):
    policy-mean actions with the stochastic env — runs any cohort size on
    the 'nn' kernel.  Mean-action mode must be action-deterministic (same
    seed -> same trace) while sampling mode differs at the same seed."""
    import jax
    import numpy as np

    from simglucose_tpu.rl.evaluate import evaluate_policy_kernel
    from simglucose_tpu.rl.policy import init_policy

    policy = init_policy(
        jax.random.PRNGKey(0), hidden=16, act="relu", init_mu_bias=-2.2
    )
    names = ["adolescent#001", "adult#003", "child#007"]
    hours = 4 * 3 / 60.0  # 4 Dexcom steps
    out1 = evaluate_policy_kernel(
        policy, names, hours=hours, seed=5, interpret=True, shard=False
    )
    out2 = evaluate_policy_kernel(
        policy, names, hours=hours, seed=5, interpret=True, shard=False
    )
    assert out1["BG"].shape == (3, 4)
    assert np.isfinite(out1["BG"]).all()
    assert (out1["BG"] > 10).all() and (out1["BG"] < 600).all()
    assert set(out1) >= {"percent_in_70_180", "LBGI", "HBGI", "risk_index"}
    # mean-action mode: same seed -> identical traces (actions carry no RNG)
    np.testing.assert_array_equal(out1["BG"], out2["BG"])
    np.testing.assert_array_equal(out1["insulin_mean"], out2["insulin_mean"])


RESIDUAL_CKPT = os.path.join(
    os.path.dirname(__file__), "..", "examples", "checkpoints",
    "ppo_cohort_residual_bb.npz",
)


@pytest.fixture(scope="module")
def residual_policy():
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.utils.checkpoint import restore_state

    if not os.path.exists(RESIDUAL_CKPT):
        pytest.fail(f"committed checkpoint missing: {RESIDUAL_CKPT}")
    like = init_policy(
        jax.random.PRNGKey(0), hidden=64, act="relu",
        action_scale=1.1, scale_by_basal=False, decoder="residual_bb",
    )
    return restore_state(RESIDUAL_CKPT, like=like)


def test_residual_checkpoint_competes_with_bb(residual_policy):
    """The shipped residual_bb checkpoint (the policy
    MODULATES basal-bolus therapy — PolicyParams.decoder docs) must
    compete with the reference's canonical BB-therapy baseline
    (reference: examples/results/2017-12-31_17-46-32/performance_stats.csv
    methodology), not merely the weak PID bar: paired 30-patient x 24 h
    evaluation at the same seed, cohort mean RI no worse than 1.05x BB,
    TIR within 2 points, hypo time no more than 0.5 points above BB.

    Certified numbers (BASELINE.md round-5, seeds 1234/77, 24 h): policy
    RI 6.832/6.426 vs BB 7.865/7.784; TIR 85.7/86.3 vs 85.7/86.3; hypo
    2.45/2.33 vs 4.90/4.65 — the shipped checkpoint strictly DOMINATES
    the baseline, so the gate margins leave ample slack for backend float
    drift."""
    import numpy as _np

    from simglucose_tpu import params as tables
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.rl.evaluate import (
        evaluate_controller,
        policy_controller,
    )

    names = tables.patient_names()
    basal = basal_rate(tables.load_patient_params(names, dtype=_np.float32))
    quest = tables.load_quest_params(names, dtype=_np.float32)
    ppo = evaluate_controller(
        policy_controller(residual_policy, basal, quest=quest),
        names, hours=24.0, seed=SEED,
    )
    bb = evaluate_controller("BB", names, hours=24.0, seed=SEED)

    ppo_ri = float(ppo["risk_index"].mean())
    bb_ri = float(bb["risk_index"].mean())
    ppo_tir = float(ppo["percent_in_70_180"].mean())
    bb_tir = float(bb["percent_in_70_180"].mean())
    ppo_hypo = float(ppo["percent_below_70"].mean())
    bb_hypo = float(bb["percent_below_70"].mean())
    assert ppo_ri <= bb_ri * 1.05, (
        f"policy RI {ppo_ri:.3f} vs BB {bb_ri:.3f}"
    )
    assert ppo_tir >= bb_tir - 2.0, (
        f"policy TIR {ppo_tir:.1f}% vs BB {bb_tir:.1f}%"
    )
    assert ppo_hypo <= bb_hypo + 0.5, (
        f"policy hypo {ppo_hypo:.2f}% vs BB {bb_hypo:.2f}%"
    )
    assert np.isfinite(ppo["BG"]).all()


def test_evaluate_policy_kernel_residual_decoder(residual_policy):
    """evaluate_policy_kernel with a residual_bb checkpoint: the kernel
    computes the BB command from the Quest planes in-kernel and modulates
    it by the policy mean — smoke + determinism at CI scale (the full
    4096-lane paired-vs-BB comparison is the BASELINE.md round-5 record).
    """
    import jax  # noqa: F401

    from simglucose_tpu.rl.evaluate import evaluate_policy_kernel

    names = ["adolescent#001", "adult#003", "child#007"]
    hours = 4 * 3 / 60.0  # 4 Dexcom steps
    out1 = evaluate_policy_kernel(
        residual_policy, names, hours=hours, seed=5, interpret=True,
        shard=False,
    )
    out2 = evaluate_policy_kernel(
        residual_policy, names, hours=hours, seed=5, interpret=True,
        shard=False,
    )
    assert out1["BG"].shape == (3, 4)
    assert np.isfinite(out1["BG"]).all()
    np.testing.assert_array_equal(out1["BG"], out2["BG"])
    # dosing is bb-anchored: mean insulin within the modulation band of
    # the therapy basal (no meal lands in this 12-min window)
    from simglucose_tpu import params as tables
    from simglucose_tpu.models.uva_padova import basal_rate

    basal = np.asarray(
        basal_rate(tables.load_patient_params(names, dtype=np.float32))
    )
    ratio = out1["insulin_mean"] / basal
    assert (ratio > np.exp(-1.2)).all() and (ratio < np.exp(1.2) + 0.5).all()
