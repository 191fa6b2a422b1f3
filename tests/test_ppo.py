"""PPO actor-learner smoke tests (single-program training iteration)."""
import jax
import numpy as np

from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.rollout import batch_reset
from simglucose_tpu.parallel.sharding import make_mesh, replicate, shard_batch
from simglucose_tpu.rl.policy import featurize, init_policy, sample_action
from simglucose_tpu.rl.ppo import (
    PPOConfig,
    TrainState,
    make_optimizer,
    make_train_step,
)


def _setup(B, rollout_steps=4):
    cfg, env_params = make_env(
        cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32
    )
    key = jax.random.PRNGKey(0)
    env_state, reset_res = batch_reset(cfg, env_params, jax.random.split(key, B))
    ppo_cfg = PPOConfig(rollout_steps=rollout_steps, epochs=1, minibatches=2)
    policy = init_policy(jax.random.fold_in(key, 1), hidden=32)
    opt_state = make_optimizer(ppo_cfg).init(policy)
    ts = TrainState(
        params=policy,
        opt_state=opt_state,
        env_state=env_state,
        prev_res=reset_res,
        key=key,
    )
    return cfg, env_params, ppo_cfg, ts


def test_policy_sample_shapes():
    from simglucose_tpu.models.uva_padova import basal_rate

    B = 8
    cfg, env_params, ppo_cfg, ts = _setup(B)
    obs = featurize(ts.prev_res, basal_rate(env_params.patient))
    basal, raw, logp, value = sample_action(
        ts.params, obs, jax.random.PRNGKey(2)
    )
    assert basal.shape == (B,)
    assert np.all(np.asarray(basal) >= 0)
    assert logp.shape == (B,) and value.shape == (B,)


def test_action_decoder_mismatch_raises():
    """A policy trained at one action parameterization cannot silently run
    under a config with another (PolicyParams carries action_scale/
    scale_by_basal as static metadata — the activation-check pattern)."""
    import pytest

    from simglucose_tpu.rl.policy import check_action_decoder

    p = init_policy(jax.random.PRNGKey(0), hidden=8)  # 0.2 / False
    with pytest.raises(ValueError, match="action decoder mismatch"):
        check_action_decoder(p, 10.0, True, "test")

    cfg, env_params, _, ts = _setup(4)
    bad_cfg = PPOConfig(
        rollout_steps=4, epochs=1, minibatches=2, action_scale=9.0
    )
    step = make_train_step(bad_cfg, cfg)
    with pytest.raises(ValueError, match="action decoder mismatch"):
        step(env_params, ts)


def test_train_step_updates_params_and_is_finite():
    B = 8
    cfg, env_params, ppo_cfg, ts = _setup(B)
    train_step = jax.jit(make_train_step(ppo_cfg, cfg))
    ts2, metrics = train_step(env_params, ts)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    # params changed
    changed = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(ts.params), jax.tree.leaves(ts2.params))
    )
    assert changed
    # a second step composes
    ts3, metrics3 = train_step(env_params, ts2)
    assert np.isfinite(float(metrics3["reward_mean"]))


def test_ppo_learns_glucose_control():
    """PPO must demonstrably LEARN, not just update.  The analog of the
    reference's end-to-end DDPG training test
    (reference: tests/test_rllab.py:13-52), with an actual improvement
    assertion instead of a smoke run.

    Design notes (measured across seeds 0-5, x64 CI config):
    * the judged quantity is a DETERMINISTIC policy evaluation (mean action,
      fixed eval key) before vs after training — training-curve rewards mix
      exploration noise with learning and are a coin flip at this scale;
    * the reward is the dense ``neg_risk_reward`` (the default risk-diff
      reward telescopes to risk[0]-risk[T] per episode, leaving almost no
      per-step signal at 1M-step scale);
    * the policy cold-starts under-insulinized (init_mu_bias=-2.2 ->
      ~0.02 U/min, hyperglycemic cohort, eval reward ~-0.72) so there is a
      steep, monotone improvement direction — it must learn to DELIVER
      insulin; worst seed of 6 improves 16%, best 62%."""
    import jax.numpy as jnp
    from functools import partial

    from simglucose_tpu.analysis.risk import neg_risk_reward
    from simglucose_tpu.core.types import CtrlAction
    from simglucose_tpu.envs.rollout import autoreset_step
    from simglucose_tpu.rl.policy import policy_apply

    B = 64
    cfg, env_params = make_env(
        cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32
    )

    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.rl.policy import iob_step

    patient_basal = basal_rate(env_params.patient)

    @jax.jit
    def eval_policy(params):
        key = jax.random.PRNGKey(123)
        env_state, res = batch_reset(cfg, env_params, jax.random.split(key, B))

        def body(carry, _):
            s, prev, cgm_prev, iob = carry
            mu, _, _ = policy_apply(
                params,
                featurize(prev, patient_basal, cgm_prev=cgm_prev, iob=iob),
            )
            basal = jax.nn.sigmoid(mu) * 0.2
            s, r, cres = jax.vmap(
                partial(autoreset_step, cfg, reward_fun=neg_risk_reward)
            )(env_params, s, CtrlAction(basal=basal, bolus=jnp.zeros_like(basal)))
            # the trend/IOB observation-memory recurrence of rl/ppo._rollout
            n_cgm_prev = jnp.where(
                r.done, cres.observation.CGM, prev.observation.CGM
            )
            n_iob = jnp.where(
                r.done, jnp.zeros_like(iob),
                iob_step(iob, r.insulin, cfg.sample_time),
            )
            return (s, cres, n_cgm_prev, n_iob), (r.reward, r.done, basal)

        (_, _, _, _), (rew, done, bas) = jax.lax.scan(
            body,
            (env_state, res, res.observation.CGM,
             jnp.zeros_like(res.observation.CGM)),
            None, length=200,
        )
        return rew.mean(), done.mean(), bas.mean()

    key = jax.random.PRNGKey(0)
    env_state, reset_res = batch_reset(
        cfg, env_params, jax.random.split(key, B)
    )
    ppo_cfg = PPOConfig(
        rollout_steps=32, epochs=4, minibatches=2, lr=3e-3, ent_coef=0.01
    )
    policy = init_policy(
        jax.random.fold_in(key, 1), hidden=64,
        init_log_std=ppo_cfg.init_log_std, init_mu_bias=-2.2,
    )
    ts = TrainState(
        params=policy,
        opt_state=make_optimizer(ppo_cfg).init(policy),
        env_state=env_state,
        prev_res=reset_res,
        key=key,
    )
    step = jax.jit(make_train_step(ppo_cfg, cfg, reward_fun=neg_risk_reward))
    r0, d0, b0 = (float(x) for x in eval_policy(policy))
    for _ in range(500):
        ts, m = step(env_params, ts)
        assert np.isfinite(float(m["reward_mean"]))
    r1, d1, b1 = (float(x) for x in eval_policy(ts.params))

    # measured on this seed: eval reward -0.72 -> -0.29, basal 0.020 -> 0.17
    assert r1 > r0 * 0.90, (r0, r1)  # >=10% less risk (worst seed: 16%)
    assert b1 > 0.022, (b0, b1)  # learned to increase insulin delivery
    assert d1 < 0.03, d1  # without runaway hypoglycemia


def test_reference_style_reward_fun_in_train_step():
    """make_train_step(reward_fun=...) must accept the reference's 1-arg
    reward over the BG-last-hour history (simulation/env.py:100-102) —
    adapted via wrap_reward_fn like every other reward_fun entry point."""
    B = 8
    cfg, env_params, ppo_cfg, ts = _setup(B)
    step = jax.jit(
        make_train_step(ppo_cfg, cfg, reward_fun=lambda bg_hist: -bg_hist[-1])
    )
    ts2, m = step(env_params, ts)
    assert np.isfinite(float(m["reward_mean"]))
    # the reward really is -CGM-scale, not risk-diff-scale
    assert float(m["reward_mean"]) < -30.0


def test_fused_train_step_t_chunk_divisibility():
    """Any rollout_steps builds, 24 included (the kernel loops over env
    steps in-kernel; there is no time chunk that must divide it)."""
    from simglucose_tpu.rl.fused import make_fused_train_step

    step = make_fused_train_step(
        PPOConfig(rollout_steps=24), 128, hidden=16, interpret=True,
    )
    assert callable(step)


def test_gae_associative_scan_matches_sequential():
    """The parallel (associative_scan) GAE must match the textbook
    sequential backward recurrence on random rewards/values/dones."""
    import jax.numpy as jnp

    from simglucose_tpu.rl.ppo import Transition, _gae

    T, B = 37, 16
    key = jax.random.PRNGKey(3)
    ks = jax.random.split(key, 4)
    traj = Transition(
        obs=jnp.zeros((T, B, 4)),
        raw_action=jnp.zeros((T, B)),
        logp=jnp.zeros((T, B)),
        value=jax.random.normal(ks[0], (T, B)),
        reward=jax.random.normal(ks[1], (T, B)),
        done=jax.random.bernoulli(ks[2], 0.1, (T, B)),
    )
    last_value = jax.random.normal(ks[3], (B,))
    cfg = PPOConfig()
    advs, rets = jax.jit(lambda t, lv: _gae(cfg, t, lv))(traj, last_value)

    # sequential reference
    v = np.asarray(traj.value)
    r = np.asarray(traj.reward)
    nonterm = 1.0 - np.asarray(traj.done).astype(np.float64)
    v_next = np.concatenate([v[1:], np.asarray(last_value)[None]], axis=0)
    delta = r + cfg.gamma * v_next * nonterm - v
    adv_ref = np.zeros((T, B))
    acc = np.zeros(B)
    for t in range(T - 1, -1, -1):
        acc = delta[t] + cfg.gamma * cfg.lam * nonterm[t] * acc
        adv_ref[t] = acc
    np.testing.assert_allclose(np.asarray(advs), adv_ref, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(rets), adv_ref + v, rtol=2e-5, atol=1e-6
    )


def test_train_step_sharded_matches_unsharded():
    B = 16
    cfg, env_params, ppo_cfg, ts = _setup(B)
    train_step = jax.jit(make_train_step(ppo_cfg, cfg))
    _, m_ref = train_step(env_params, ts)

    mesh = make_mesh(dp=8, tp=1)
    env_params_s = shard_batch(env_params, mesh)
    ts_s = TrainState(
        params=replicate(ts.params, mesh),
        opt_state=replicate(ts.opt_state, mesh),
        env_state=shard_batch(ts.env_state, mesh),
        prev_res=shard_batch(ts.prev_res, mesh),
        key=replicate(ts.key, mesh),
    )
    train_step_s = jax.jit(make_train_step(ppo_cfg, cfg, mesh=mesh))
    with mesh:
        _, m_sh = train_step_s(env_params_s, ts_s)
    np.testing.assert_allclose(
        float(m_ref["reward_mean"]), float(m_sh["reward_mean"]), rtol=1e-4
    )


def test_train_step_with_reset_cadence():
    """reset_cadence > 1 (cadenced rare-path sampling, PPOConfig) must
    train identically in kind: finite metrics, params update, and the
    validation errors fire on bad configs."""
    import dataclasses

    import pytest

    B = 8
    cfg, env_params, ppo_cfg, ts = _setup(B, rollout_steps=8)
    ppo_k = dataclasses.replace(ppo_cfg, reset_cadence=4)
    step = jax.jit(make_train_step(ppo_k, cfg))
    ts2, m = step(env_params, ts)
    for k, v in m.items():
        assert np.isfinite(float(v)), k
    changed = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(ts.params), jax.tree.leaves(ts2.params))
    )
    assert changed

    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(dataclasses.replace(ppo_cfg, reset_cadence=3), cfg)
    with pytest.raises(ValueError, match="meal-free"):
        make_train_step(
            dataclasses.replace(
                ppo_cfg, rollout_steps=1024, reset_cadence=128
            ),
            cfg,
        )
