"""Checks that need the card: the compiled Triton kernel against the XLA
env path at real width, the in-kernel policy against the XLA policy
forward, and the golden trace on the GPU.  They skip elsewhere; run them
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


@pytest.mark.gpu
def test_golden_parity_on_gpu(gpu):
    """The 2-day closed-loop golden through the XLA env path on the GPU
    (float64, rk45) at the CPU tolerances."""
    res = {}
    _smoke().phase_golden(res)  # asserts BG <= 5e-8, CHO/insulin <= 1e-12
    assert res["golden_max_rel_err"]["BG"] <= 5e-8


@pytest.mark.gpu
def test_kernel_matches_env_at_width(gpu):
    """The compiled kernel's deterministic PID config against env_step at
    B=4096, with the tolerances of the interpret-mode parity test."""
    err = _smoke().deterministic_parity(4096, 6)
    assert err["CHO_equal"] and err["done_equal"], err
    assert err["BG"] <= 2e-6 and err["CGM"] <= 2e-6, err
    assert err["insulin"] <= 1e-6, err


@pytest.mark.gpu
def test_nn_kernel_matches_xla_policy(gpu):
    """The in-kernel MLP (f32 FMAs) against rl/policy.policy_apply
    (precision HIGHEST, full f32) on the kernel's own observations,
    B=4096: mean actions agree to f32 summation-order differences."""
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import (
        PallasRolloutConfig,
        make_pallas_rollout,
        pack_params,
        pack_policy_weights,
    )
    from simglucose_tpu.rl.policy import featurize_parts, init_policy, \
        policy_apply

    B, T, H = 4096, 16, 64
    _, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
    basal = basal_rate(params.patient)
    packed = pack_params(params.patient, basal)
    policy = init_policy(jax.random.PRNGKey(0), hidden=H, act="relu",
                         init_mu_bias=-1.0)
    cfg = PallasRolloutConfig(n_steps=T, deterministic=True, controller="nn",
                              nn_hidden=H, det_meal_times=(3, 20),
                              det_meal_amounts=(30.0, 40.0))
    traj = jax.jit(lambda p, w: make_pallas_rollout(cfg, B)(p, 0, weights=w))(
        packed, pack_policy_weights(policy))
    obs = featurize_parts(traj["octrl"], traj["oins"], traj["ocho"],
                          traj["oprev"], traj["oiob"], jnp.asarray(basal))
    mu, _, _ = jax.jit(lambda o: policy_apply(policy, o))(obs)
    np.testing.assert_allclose(np.asarray(traj["raw"]), np.asarray(mu),
                               rtol=1e-5, atol=1e-5)
