"""Gymnasium adapter tests (reference: tests/test_gym.py, test_seed.py,
test_reset.py, test_reward_fun.py)."""
from datetime import datetime

import numpy as np
import pytest

gymnasium = pytest.importorskip("gymnasium")

from simglucose_tpu.envs.gym_env import (  # noqa: E402
    T1DSimGymEnv,
    T1DSimVectorEnv,
    register_envs,
)


def test_gym_make_and_run():
    """register -> gym.make -> steps (reference: tests/test_gym.py:6-35)."""
    register_envs()
    env = gymnasium.make(
        "simglucose-v0", patient_name="adolescent#002", seed=3
    )
    obs, info = env.reset()
    assert obs.shape == (1,)
    assert info["patient_name"] == "adolescent#002"
    total = 0.0
    for _ in range(20):
        act = env.action_space.sample() * 0  # zero basal
        obs, reward, terminated, truncated, info = env.step(act)
        total += reward
        assert obs[0] >= 0
        assert np.isfinite(reward)
        if terminated or truncated:
            obs, info = env.reset()
    env.close()


def test_seed_start_time_parity():
    """seed(0) + reset() must land on the reference's exact start time
    (reference: tests/test_seed.py:17-21 -> 2018-01-01 23:00:00; seed 1000 ->
    14:00).  seed() consumes one seed-chain draw, reset() a second, exactly
    like the reference's env-rebuild-per-call."""
    env = T1DSimGymEnv(patient_name="adult#001", seed=0)
    env.reset()
    assert env.start_time == datetime(2018, 1, 1, 23, 0, 0)
    env.seed(1000)
    env.reset()
    assert env.start_time == datetime(2018, 1, 1, 14, 0, 0)


def test_different_seeds_different_obs():
    """reference: tests/test_seed.py:22-27."""
    obs = []
    for seed in (0, 1, 2):
        env = T1DSimGymEnv(patient_name="adolescent#001", seed=seed)
        o, _ = env.reset(seed=seed)
        obs.append(float(o[0]))
    assert len(set(obs)) == 3


def test_reset_sequence_replays_after_reseed():
    """Successive resets differ, but the reset SEQUENCE replays identically
    after re-seeding (reference: tests/test_reset.py:28-57)."""
    env = T1DSimGymEnv(patient_name="adolescent#001", seed=7)
    seq1 = [float(env.reset()[0][0]) for _ in range(3)]
    env.seed(7)
    seq2 = [float(env.reset()[0][0]) for _ in range(3)]
    assert len(set(seq1)) > 1  # resets differ from each other
    assert seq1 == seq2  # sequence replays after re-seed


def test_custom_reward_fun():
    """Custom reference-style reward plumbed through
    (reference: tests/test_reward_fun.py:15-48)."""

    def custom_reward(bg_hist):
        bg = bg_hist[-1]
        import jax.numpy as jnp

        return jnp.where(bg > 180, -1.0, jnp.where(bg < 70, -2.0, 1.0))

    env = T1DSimGymEnv(
        patient_name="adolescent#001", seed=4, reward_fun=custom_reward
    )
    env.reset()
    for _ in range(5):
        _, reward, term, trunc, _ = env.step(np.asarray([0.01]))
        assert reward in (-1.0, -2.0, 1.0)
        if term:
            break


def test_reward_window_variable_length_at_episode_start():
    """A mean-based 1-arg reward must see ONLY the real CGM history at
    episode start, exactly like the reference's Python list slice
    ``CGM_hist[-window:]`` (reference: simulation/env.py:100-102) — never the
    zero-padded ring buffer."""
    import jax.numpy as jnp

    def mean_reward(bg_hist):
        return jnp.mean(bg_hist)

    env = T1DSimGymEnv(
        patient_name="adolescent#001", seed=11, reward_fun=mean_reward
    )
    obs0, _ = env.reset()
    cgm_hist = [env._history[0]["CGM"]]  # reset history sample (env.py:126)
    for k in range(4):
        obs, reward, term, trunc, _ = env.step(np.asarray([0.01]))
        cgm_hist.append(env._history[-1]["CGM"])
        expected = np.mean(cgm_hist)  # k+2 real samples, window is 20
        np.testing.assert_allclose(reward, expected, rtol=1e-6)
        # the zero-padded mean would be ~10x smaller — guard the regression
        padded = np.sum(cgm_hist) / env.cfg.window_size
        assert abs(reward - padded) > 1.0


def test_custom_scenario():
    """Custom meal scenario delivers at the requested minute
    (reference: simulation/scenario.py:21-45)."""
    env = T1DSimGymEnv(
        patient_name="adolescent#001",
        custom_scenario=[(0.05, 30.0)],  # 3 minutes in, 30 g
        seed=1,
    )
    env.reset()
    meals = []
    for _ in range(3):
        _, _, _, _, info = env.step(np.asarray([0.0]))
        meals.append(info["meal"])
    # minute-3 meal lands in the second env step (minutes 3-5 @ Dexcom),
    # averaged over the 3 mini-steps: 30 g eaten at EAT_RATE=5 g/min
    assert meals[1] > 0 and meals[0] == 0


def test_info_dict_fields():
    env = T1DSimGymEnv(patient_name="child#001", seed=2)
    _, info = env.reset()
    for k in (
        "sample_time",
        "patient_name",
        "meal",
        "patient_state",
        "time",
        "bg",
        "lbgi",
        "hbgi",
        "risk",
    ):
        assert k in info
    assert info["patient_state"].shape == (13,)
    assert isinstance(info["time"], datetime)


def test_show_history():
    env = T1DSimGymEnv(patient_name="adolescent#001", seed=5)
    env.reset()
    for _ in range(4):
        env.step(np.asarray([0.01]))
    df = env.show_history()
    assert len(df) == 5  # reset + 4 steps
    assert set(df.columns) >= {"BG", "CGM", "CHO", "insulin", "Risk"}


def test_vector_env():
    env = T1DSimVectorEnv(num_envs=8, seed=0)
    obs, info = env.reset()
    assert obs.shape == (8, 1)
    for _ in range(3):
        obs, rew, term, trunc, info = env.step(np.zeros((8, 1)))
        assert obs.shape == (8, 1)
        assert rew.shape == (8,)
        assert np.isfinite(rew).all()


def test_horizon_days_truncates_native_mode():
    """horizon_days bounds native-mode episodes too (it was a silent no-op
    outside compat mode in round 1)."""
    env = T1DSimGymEnv(
        patient_name="adolescent#001", seed=3, horizon_days=9.0 / 1440
    )  # 9-minute horizon = 3 Dexcom steps
    env.reset()
    truncs = []
    for _ in range(3):
        _, _, term, trunc, _ = env.step(np.asarray([0.01]))
        truncs.append(trunc)
        if term:
            return  # terminated before the horizon; nothing to assert
    assert truncs == [False, False, True]


def test_noise_mode_config_authoritative():
    """cfg.noise_mode must agree with EnvParams.noise_seq — silent fallback
    to the other noise source is an error now."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import pytest

    from simglucose_tpu.envs.build import make_env
    from simglucose_tpu.envs.functional import env_reset

    cfg, params = make_env("adolescent#001", dtype=np.float64)
    # exogenous mode without a noise_seq
    cfg_ex = dataclasses.replace(cfg, noise_mode="exogenous")
    with pytest.raises(ValueError, match="noise_seq"):
        env_reset(cfg_ex, params, jax.random.PRNGKey(0))
    # native mode with a stray noise_seq
    params_seq = params._replace(noise_seq=jnp.zeros(16, jnp.float64))
    with pytest.raises(ValueError, match="noise_mode"):
        env_reset(cfg, params_seq, jax.random.PRNGKey(0))


def test_vector_env_autoreset_gives_reset_obs():
    """Gymnasium same-step autoreset convention: on termination the returned
    obs is the NEW episode's reset observation and the terminal step moves to
    info['final_observation'] (the reference wrapper gives the agent the
    fresh episode's obs after done, simglucose_gym_env.py:48-51)."""
    env = T1DSimVectorEnv(num_envs=4, seed=7)
    obs, info = env.reset()
    # max-basal insulin floods the patients -> hypoglycemia -> done quickly
    action = np.full((4, 1), 30.0, np.float32)
    saw_done = False
    for _ in range(400):
        obs, rew, term, trunc, info = env.step(action)
        if term.any():
            saw_done = True
            assert "final_observation" in info
            assert "final_info" in info
            for i in range(4):
                if term[i]:
                    fin = info["final_observation"][i]
                    assert fin is not None and fin.shape == (1,)
                    # terminal CGM is out of the [70, 350] band (modulo
                    # sensor noise); the returned obs belongs to a fresh
                    # episode whose BG started in the normal range
                    assert info["final_info"][i]["bg"] < 70.0 or (
                        info["final_info"][i]["bg"] > 350.0
                    )
                    assert obs[i, 0] != fin[0]
                    assert 70.0 < info["bg"][i] < 350.0
                else:
                    assert info["final_observation"][i] is None
            assert (info["_final_observation"] == term).all()
            break
    assert saw_done, "expected a termination within 400 max-basal steps"


def test_action_observation_spaces():
    env = T1DSimGymEnv(patient_name="adolescent#001", seed=0)
    assert env.action_space.shape == (1,)
    assert float(env.action_space.high[0]) == 30.0  # Insulet max basal
    assert env.observation_space.shape == (1,)


def test_vector_env_truncation_horizon():
    """truncated fires at the horizon (parity with the single env's
    horizon_days) and the env auto-resets those lanes same-step."""
    env = T1DSimVectorEnv(
        num_envs=4, seed=1, horizon_days=9.0 / 1440
    )  # 9 minutes = 3 Dexcom steps
    assert env.horizon_steps == 3
    env.reset()
    a = np.full((4, 1), 0.01, np.float32)
    flags = []
    for _ in range(4):
        obs, rew, term, trunc, info = env.step(a)
        flags.append(trunc.copy())
        if trunc.any():
            assert "final_observation" in info
    # episode_step hits the horizon at step 3, then the fresh episodes run
    assert not flags[0].any() and not flags[1].any()
    assert flags[2].all()
    assert not flags[3].any()
    # Gymnasium 1.x autoreset declaration
    import gymnasium

    if hasattr(gymnasium.vector, "AutoresetMode"):
        assert (
            env.metadata["autoreset_mode"]
            == gymnasium.vector.AutoresetMode.SAME_STEP
        )


def test_vector_env_step_n_single_dispatch():
    """step_n runs N policy-driven steps per compiled dispatch with correct
    same-step autoreset bookkeeping."""
    import jax.numpy as jnp

    B, n = 256, 50
    env = T1DSimVectorEnv(num_envs=B, seed=3)
    obs0, _ = env.reset()

    # max-basal policy floods the patients -> guaranteed terminations
    policy = lambda obs: jnp.full((obs.shape[0], 1), 30.0, jnp.float32)
    obs, rew, term, trunc, infos = env.step_n(n, policy)
    assert obs.shape == (n, B, 1) and rew.shape == (n, B)
    assert term.shape == (n, B) and trunc.shape == (n, B)
    assert len(env._stepn_cache) == 1  # one compiled program
    assert term.any(), "no terminations at max basal?"
    assert np.isfinite(rew).all()
    t, b = np.argwhere(term)[0]
    # terminal CGM (final_observation) is recorded and out-of-band low/high,
    # while the returned obs for that step belongs to the fresh episode
    fin = infos["final_observation"][t, b]
    assert np.isfinite(fin)
    assert infos["final_info"]["bg"][t, b] < 70.0 or (
        infos["final_info"]["bg"][t, b] > 350.0
    )
    assert obs[t, b, 0] != fin
    # second call reuses the compiled program (100 steps in 2 dispatches)
    obs2, *_ = env.step_n(n, policy)
    assert len(env._stepn_cache) == 1
    assert obs2.shape == (n, B, 1)
