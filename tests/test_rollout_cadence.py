"""Cadenced auto-reset engine (envs/rollout.py ``reset_cadence``).

The cadenced engine amortizes the rare-path sampling (fresh-episode reset
candidates, midnight scenario regeneration) over chunks of K steps — the
XLA analog of the pallas kernel's ``regen_every``.  Contract:

  * lanes that never terminate produce BIT-IDENTICAL trajectories to the
    exact per-step engine (the deferred midnight regen lands inside the
    post-midnight meal-free window — all meal slots are truncated to
    [05:00, 23:00], reference scenario_gen.py:36-44);
  * lanes that terminate adopt a chunk candidate: same reset law (uniform
    start hour, fresh episode key), so cohort statistics must match the
    exact engine's.
"""
import dataclasses

import jax
import numpy as np
import pytest

from simglucose_tpu.controllers.functional import pid_controller
from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.rollout import (
    batch_reset,
    broadcast_ctrl_state,
    make_batch_rollout_fn,
)


def _setup(B, random_init_bg=True, **cfg_kw):
    cfg, params = make_env(
        cohort_names(B), batch=True, random_init_bg=random_init_bg,
        dtype=np.float32,
    )
    cfg = dataclasses.replace(cfg, **cfg_kw)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, reset_res = jax.jit(lambda p, k: batch_reset(cfg, p, k))(
        params, keys
    )
    cs = broadcast_ctrl_state(ctrl0, B)
    return cfg, params, ctrl, state, cs, reset_res


def test_cadence_trajectory_exact_when_no_terminations():
    """With terminations disabled, K=16 must be bit-identical to K=1 —
    including lanes whose random start hour crosses midnight inside the
    horizon (the deferred-regen case)."""
    B, T, K = 16, 128, 16  # 384 simulated minutes; hours >= 18 cross midnight
    cfg, params, ctrl, state, cs, rres = _setup(
        B, bg_done_low=-1.0, bg_done_high=1e9
    )
    run1 = make_batch_rollout_fn(cfg, ctrl, n_steps=T, donate=False)
    runK = make_batch_rollout_fn(
        cfg, ctrl, n_steps=T, donate=False, reset_cadence=K
    )
    _, _, t1 = run1(params, state, cs, rres)
    _, _, tK = runK(params, state, cs, rres)
    # some lane must actually cross midnight or the regen path is untested
    start_mod = np.asarray(state.scenario.start_min) % 1440
    assert (start_mod + T * cfg.sample_time > 1440).any()
    np.testing.assert_array_equal(np.asarray(t1.CHO), np.asarray(tK.CHO))
    np.testing.assert_array_equal(np.asarray(t1.BG), np.asarray(tK.BG))
    np.testing.assert_array_equal(np.asarray(t1.CGM), np.asarray(tK.CGM))
    np.testing.assert_array_equal(
        np.asarray(t1.reward), np.asarray(tK.reward)
    )


def test_cadence_resets_preserve_law():
    """With real terminations the cadenced engine must reproduce the exact
    engine's cohort statistics (same reset law, candidates drawn early)."""
    B, T, K = 64, 256, 16
    cfg, params, ctrl, state, cs, rres = _setup(B)
    run1 = make_batch_rollout_fn(cfg, ctrl, n_steps=T, donate=False)
    runK = make_batch_rollout_fn(
        cfg, ctrl, n_steps=T, donate=False, reset_cadence=K
    )
    _, _, t1 = run1(params, state, cs, rres)
    _, last, tK = runK(params, state, cs, rres)
    d1 = float(np.asarray(t1.done).mean())
    dK = float(np.asarray(tK.done).mean())
    assert dK > 0, "no terminations — the adoption path is untested"
    # done rates agree to within sampling noise (both ~0.8%/step)
    assert 0.3 * d1 <= dK <= 3.0 * max(d1, 1e-4)
    bgK = np.asarray(tK.BG)
    assert np.isfinite(bgK).all()
    assert 120.0 < bgK.mean() < 260.0
    # every post-termination step continues from a live episode: BG stays
    # inside the sensor-plausible range (a stuck terminal state would pin
    # BG outside the done band)
    done_frac_tail = float(np.asarray(tK.done)[-K:].mean())
    assert done_frac_tail < 0.1


def test_cadence_second_termination_gets_fresh_candidate():
    """A lane terminating more than once within one chunk must NOT replay
    an identical episode start: the chunk draws C=2
    candidates and the second adoption takes the second one."""
    B, T, K = 4, 8, 8
    # bg_done_low=1e9 makes every step terminal -> every step adopts
    cfg, params, ctrl, state, cs, rres = _setup(
        B, random_init_bg=True, bg_done_low=1e9
    )
    runK = make_batch_rollout_fn(
        cfg, ctrl, n_steps=T, donate=False, reset_cadence=K
    )
    _, _, tK = runK(params, state, cs, rres)
    bg = np.asarray(tK.BG)  # [T, B]
    assert np.asarray(tK.done).all()
    # step 1 steps out of candidate 0, step 2 out of candidate 1: with the
    # old single-candidate replay these rows were identical
    assert (bg[1] != bg[2]).any()
    # steps >= 2 all re-adopt candidate C-1 == 1 -> identical restarts
    np.testing.assert_array_equal(bg[2], bg[3])


def test_cadence_validation():
    B = 4
    cfg, params, ctrl, *_ = _setup(B)
    with pytest.raises(ValueError, match="not divisible"):
        make_batch_rollout_fn(cfg, ctrl, n_steps=100, reset_cadence=16)
    with pytest.raises(ValueError, match="meal-free"):
        make_batch_rollout_fn(cfg, ctrl, n_steps=1024, reset_cadence=128)
