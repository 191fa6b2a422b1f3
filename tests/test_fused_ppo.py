"""Pallas-fused PPO actor: the 'nn' kernel controller must reproduce the
XLA policy-driven env rollout exactly (deterministic config), and the fused
train step must run end-to-end with persistent episode state.  Runs in
pallas interpret mode on CPU (the compiled kernel runs on a GPU,
tests/test_gpu.py)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from simglucose_tpu.core.types import CtrlAction
from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.rollout import autoreset_step, batch_reset
from simglucose_tpu.models.uva_padova import basal_rate
from simglucose_tpu.ops.pallas_rollout import (
    PallasRolloutConfig,
    make_pallas_rollout,
    pack_params,
    pack_policy_weights,
)
from simglucose_tpu.rl.policy import featurize, init_policy, policy_apply

B = 128  # one lane row per block for the interpret-mode tests
H = 16  # small relu trunk keeps interpret tracing fast


def _policy(key=0):
    return init_policy(
        jax.random.PRNGKey(key), hidden=H, init_log_std=-0.5,
        init_mu_bias=-1.0, act="relu",
    )


def test_nn_controller_matches_xla_policy_rollout():
    """Deterministic config (no noise / static meals / no resets): the
    kernel's in-kernel MLP policy (packed weights) must drive the
    env to the SAME trajectory as policy_apply + the XLA env path, and the
    kernel's raw-action / observation outputs must reconstruct exactly."""
    names = cohort_names(B)
    env_params, params = None, None
    cfg_env, params = make_env(names, batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    policy = _policy()

    # a few steps keep the interpret-mode run short
    T = 4
    meal_times = (3, 10)
    meal_amounts = (30.0, 25.0)
    scale = 0.2
    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=True,
        controller="nn", nn_hidden=H, nn_action_scale=scale,
        det_meal_times=meal_times, det_meal_amounts=meal_amounts,
    )
    run = make_pallas_rollout(pcfg, B, interpret=True)
    traj_p = run(packed, 0, weights=pack_policy_weights(policy))

    # XLA path: deterministic env + the same policy (mean action, no
    # sampling), featurize on the autoreset carry exactly like rl/ppo.py
    meal_seq = np.zeros(T * 3 + 1, np.float32)
    for t, a in zip(meal_times, meal_amounts):
        meal_seq[t] = a
    cfg, eparams = make_env(
        names,
        batch=True,
        dtype=np.float32,
        scenario_mode="exogenous",
        meal_seq=meal_seq,
        noise_seq=np.zeros(T + 4, np.float32),
        substeps=1,
        method="rk4",
    )
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, eparams, keys, start_min=0)
    patient_basal = basal_rate(eparams.patient)

    from simglucose_tpu.rl.policy import featurize_parts, iob_step

    def body(carry, _):
        s, prev, cgm_prev, iob = carry
        obs = featurize(prev, patient_basal, cgm_prev=cgm_prev, iob=iob)
        mu, _, _ = policy_apply(policy, obs)
        basal = jax.nn.sigmoid(mu) * scale
        s, r, cres = jax.vmap(partial(autoreset_step, cfg))(
            eparams, s, CtrlAction(basal=basal, bolus=jnp.zeros_like(basal))
        )
        # observation-memory recurrence of rl/ppo._rollout (no resets in
        # the deterministic config, but keep the done-handling identical)
        n_cgm_prev = jnp.where(
            r.done, cres.observation.CGM, prev.observation.CGM
        )
        n_iob = jnp.where(
            r.done, jnp.zeros_like(iob),
            iob_step(iob, r.insulin, cfg.sample_time),
        )
        return (s, cres, n_cgm_prev, n_iob), (r, obs, mu)

    (_, _, _, _), (traj_e, obs_e, mu_e) = jax.lax.scan(
        body,
        (state, res, res.observation.CGM,
         jnp.zeros_like(res.observation.CGM)),
        None, length=T,
    )

    # the kernel's observation planes reconstruct the XLA featurize inputs
    # (same featurize_parts call the fused learner makes, rl/fused.py)
    obs_p = np.asarray(
        featurize_parts(
            jnp.asarray(traj_p["octrl"]),
            jnp.asarray(traj_p["oins"]),
            jnp.asarray(traj_p["ocho"]),
            jnp.asarray(traj_p["oprev"]),
            jnp.asarray(traj_p["oiob"]),
            patient_basal,
        )
    )
    # atol covers the trend feature: (cgm - cgm_prev) is a difference of two
    # near-equal f32 values that themselves agree only to ~1e-5 relative
    np.testing.assert_allclose(obs_p, np.asarray(obs_e), rtol=1e-5, atol=1e-5)
    # deterministic mode: raw == mu — the in-kernel MLP (packed
    # weights) agrees with policy_apply on the same observations
    np.testing.assert_allclose(
        np.asarray(traj_p["raw"]), np.asarray(mu_e), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["insulin"]), np.asarray(traj_e.insulin), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["BG"]), np.asarray(traj_e.BG), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["CGM"]), np.asarray(traj_e.CGM), rtol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(traj_p["CHO"]), np.asarray(traj_e.CHO)
    )
    # tail obs row = the observation the next step would act on
    np.testing.assert_allclose(
        np.asarray(traj_p["tail_octrl"]),
        np.asarray(traj_e.CGM)[-1],
        rtol=1e-5,
    )


def test_fused_train_step_runs_and_carries_state():
    """Stochastic fused iteration (sw PRNG, interpret): metrics finite,
    params update, and the persistent simulator state threads through —
    the second iteration continues episodes rather than re-initializing."""
    from simglucose_tpu.rl.fused import (
        FusedTrainState,
        init_fused_state,
        make_fused_train_step,
    )
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer

    names = cohort_names(B)
    _, params = make_env(names, batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    policy = _policy(1)
    cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
    ts = init_fused_state(
        policy, make_optimizer(cfg).init(policy), B, jax.random.PRNGKey(0)
    )
    step = make_fused_train_step(
        cfg, B, hidden=H, interpret=True,
    )
    ts1, m1 = step(packed, ts)
    for k, v in m1.items():
        assert np.isfinite(float(v)), k
    changed = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(ts.params), jax.tree.leaves(ts1.params))
    )
    assert changed
    assert int(ts1.init) == 0
    # state planes are live (episode clocks advanced: t_min plane nonzero)
    assert np.asarray(ts1.state_i[0]).max() > 0
    t_min_after_1 = np.asarray(ts1.state_i[0]).copy()

    ts2, m2 = step(packed, ts1)
    assert np.isfinite(float(m2["reward_mean"]))
    t_min_after_2 = np.asarray(ts2.state_i[0])
    # episodes CONTINUED: clocks advanced further for (most) lanes rather
    # than restarting from a fresh init
    frac_advanced = (t_min_after_2 > t_min_after_1).mean()
    assert frac_advanced > 0.8, frac_advanced


def test_pack_policy_weights_rejects_wrong_activation():
    """The kernel trunk is relu; a tanh-trained checkpoint must be rejected
    loudly (the activation is static PolicyParams metadata), never silently
    run as a different network."""
    import pytest

    tanh_policy = init_policy(jax.random.PRNGKey(0), hidden=16)  # act='tanh'
    with pytest.raises(ValueError, match="relu trunk"):
        pack_policy_weights(tanh_policy)
    # and the activation survives a checkpoint round-trip (static metadata
    # travels in the tree structure)
    from simglucose_tpu.utils.checkpoint import restore_state, save_state

    relu_policy = init_policy(jax.random.PRNGKey(0), hidden=16, act="relu")
    path = "/tmp/test_policy_act.npz"
    save_state(path, relu_policy)
    restored = restore_state(path, like=relu_policy)
    assert restored.act == "relu"
    pack_policy_weights(restored)  # accepted


def test_fused_train_loop_scans_iterations():
    """make_fused_train_loop: K iterations in one program — metrics stack
    [K] and the state threads through the scan."""
    from simglucose_tpu.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer

    names = cohort_names(B)
    _, params = make_env(names, batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    policy = init_policy(
        jax.random.PRNGKey(3), hidden=16, init_mu_bias=-1.0, act="relu"
    )
    cfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=2)
    ts = init_fused_state(
        policy, make_optimizer(cfg).init(policy), B, jax.random.PRNGKey(0)
    )
    loop = make_fused_train_loop(
        cfg, B, 2, hidden=16, interpret=True,
    )
    ts1, m = loop(packed, ts)
    assert m["reward_mean"].shape == (2,)
    assert np.isfinite(np.asarray(m["reward_mean"])).all()
    assert int(ts1.init) == 0
    assert np.asarray(ts1.state_i[0]).max() > 0


def test_fused_continuing_mode():
    """continuing=True: auto-reset off in the kernel config, GAE sees no
    terminals, and episodes thread across iterations until the caller
    re-inits (the train/eval-matched objective — see make_fused_train_step
    docs)."""
    from simglucose_tpu.rl.fused import init_fused_state, make_fused_train_step
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer

    names = cohort_names(B)
    _, params = make_env(names, batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    policy = init_policy(
        jax.random.PRNGKey(3), hidden=16, init_mu_bias=-1.0, act="relu"
    )
    cfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=2)
    ts = init_fused_state(
        policy, make_optimizer(cfg).init(policy), B, jax.random.PRNGKey(0)
    )
    step = make_fused_train_step(
        cfg, B, hidden=16, interpret=True, continuing=True,
    )
    ts1, m = step(packed, ts)
    assert np.isfinite(float(m["reward_mean"]))
    # persistent clock advanced; a caller re-init flag threads through
    assert np.asarray(ts1.state_i[0]).max() > 0
    assert int(ts1.init) == 0
    ts2, _ = step(packed, ts1._replace(init=ts1.init + 1))
    assert np.isfinite(np.asarray(ts2.state_f[12]).mean())


def test_neg_risk_reward_kind():
    """reward_kind='neg_risk': the kernel's reward plane must equal
    -RI(CGM)/10 of its own CGM plane (analysis/risk.py law)."""
    from simglucose_tpu.analysis.risk import risk_scalar

    names = cohort_names(B)
    _, params = make_env(names, batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    T = 4
    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=True,
        controller="pid", reward_kind="neg_risk",
    )
    traj = make_pallas_rollout(pcfg, B, interpret=True)(packed, 0)
    _, _, ri = risk_scalar(jnp.asarray(traj["CGM"]))
    np.testing.assert_allclose(
        np.asarray(traj["reward"]), -0.1 * np.asarray(ri),
        rtol=1e-5, atol=1e-7,
    )


def test_fused_train_step_sharded_over_mesh():
    """Multi-chip fused training (BASELINE config 5 analog): one kernel per
    device under shard_map, weights replicated, learner gradients
    all-reduced by GSPMD.  Runs on the virtual 8-device CPU mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from simglucose_tpu.parallel.sharding import make_mesh
    from simglucose_tpu.rl.fused import (
        init_fused_state,
        make_fused_train_step,
    )
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer

    n_dev = 8
    mesh = make_mesh(dp=n_dev, tp=1)
    Bs = n_dev * 128
    names = cohort_names(Bs)
    _, params = make_env(names, batch=True, dtype=np.float32)
    packed = jax.device_put(
        pack_params(params.patient, basal_rate(params.patient)),
        NamedSharding(mesh, P(None, "dp")),
    )
    policy = _policy(2)
    cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
    ts = init_fused_state(
        policy, make_optimizer(cfg).init(policy), Bs, jax.random.PRNGKey(0),
        mesh=mesh,
    )
    step = make_fused_train_step(
        cfg, Bs, hidden=H, interpret=True, mesh=mesh,
    )
    with mesh:
        ts1, m = step(packed, ts)
    for k, v in m.items():
        assert np.isfinite(float(v)), k
    # params updated identically on every device (replicated post-update)
    assert len(ts1.state_f.sharding.device_set) == n_dev
    changed = any(
        not np.allclose(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(ts.params), jax.tree.leaves(ts1.params))
    )
    assert changed


def test_nn_controller_exogenous_noise_matches_env_exactly():
    """NONZERO noise through the 'nn' kernel: the
    fused actor consumes the same MT19937-bit-exact reference CGM noise
    planes the env path does (deterministic policy-mean actions, static
    meals) and must reproduce the XLA policy rollout noise-for-noise — the
    same golden the PID/BB kernel already has
    (tests/test_pallas_rollout.py::test_exogenous_noise_matches_env_exactly)."""
    from simglucose_tpu.compat.noise import reference_cgm_noise
    from simglucose_tpu.params import sensor_record

    names = cohort_names(B)
    cfg_env, params = make_env(names, batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    policy = _policy()

    T = 4
    meal_times = (3, 10)
    meal_amounts = (30.0, 25.0)
    scale = 0.2
    noise = reference_cgm_noise(sensor_record("Dexcom"), 1, T + 2).astype(
        np.float32
    )
    rows = B // 128
    bc = lambda a: np.broadcast_to(a[:, None], (len(a), B))

    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=True,
        exogenous_noise=True, autoreset=False,
        controller="nn", nn_hidden=H, nn_action_scale=scale,
        det_meal_times=meal_times, det_meal_amounts=meal_amounts,
    )
    run = make_pallas_rollout(pcfg, B, interpret=True)
    traj_p = run(
        packed, 0, bc(noise[:2]), bc(noise[2:]),
        weights=pack_policy_weights(policy),
    )

    meal_seq = np.zeros(T * 3 + 1, np.float32)
    for t, a in zip(meal_times, meal_amounts):
        meal_seq[t] = a
    cfg, eparams = make_env(
        names,
        batch=True,
        dtype=np.float32,
        scenario_mode="exogenous",
        meal_seq=meal_seq,
        noise_seq=noise,
        substeps=1,
        method="rk4",
    )
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, eparams, keys, start_min=0)
    patient_basal = basal_rate(eparams.patient)

    from simglucose_tpu.envs.rollout import make_batch_continue_fn
    from simglucose_tpu.rl.evaluate import policy_controller
    from simglucose_tpu.envs.rollout import broadcast_ctrl_state

    ctrl0, ctrl, _ = policy_controller(
        policy, patient_basal, sample_time=cfg.sample_time
    )
    run_env = make_batch_continue_fn(cfg, ctrl, T)
    _, _, _, traj_e = run_env(eparams, state, ctrl0, res)

    assert abs(noise[0]) > 1.0  # the noise is real
    np.testing.assert_allclose(
        np.asarray(traj_p["CGM0"]), np.asarray(res.CGM), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["CGM"]), np.asarray(traj_e.CGM), rtol=2e-5, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["BG"]), np.asarray(traj_e.BG), rtol=2e-5, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["insulin"]), np.asarray(traj_e.insulin),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(traj_p["CHO"]), np.asarray(traj_e.CHO)
    )


def test_nn_residual_bb_decoder_matches_xla():
    """decoder='residual_bb' (the policy multiplicatively modulates
    basal-bolus therapy — PolicyParams.decoder docs): the kernel's
    in-kernel BB command + exp(scale*tanh(raw)) modulation must drive the
    env to the same trajectory as the XLA env path applying
    policy_controller's residual law, through a meal (bolus branch) and a
    correction (G>150 branch)."""
    import dataclasses

    from simglucose_tpu.params import load_quest_params

    names = cohort_names(B)
    cfg_env, params = make_env(names, batch=True, dtype=np.float32)
    quest = load_quest_params(names, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient),
                         quest=quest)
    policy = dataclasses.replace(
        _policy(), decoder="residual_bb", action_scale=1.1,
        scale_by_basal=False,
    )

    T = 4
    meal_times = (3,)
    meal_amounts = (45.0,)
    scale = 1.1
    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=True,
        controller="nn", nn_hidden=H, nn_action_scale=scale,
        nn_decoder="residual_bb",
        det_meal_times=meal_times, det_meal_amounts=meal_amounts,
    )
    run = make_pallas_rollout(pcfg, B, interpret=True)
    traj_p = run(packed, 0, weights=pack_policy_weights(policy))

    meal_seq = np.zeros(T * 3 + 1, np.float32)
    for t, a in zip(meal_times, meal_amounts):
        meal_seq[t] = a
    cfg, eparams = make_env(
        names,
        batch=True,
        dtype=np.float32,
        scenario_mode="exogenous",
        meal_seq=meal_seq,
        noise_seq=np.zeros(T + 4, np.float32),
        substeps=1,
        method="rk4",
    )
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, eparams, keys, start_min=0)
    patient_basal = basal_rate(eparams.patient)
    cr = jnp.asarray(quest.CR)
    cf = jnp.asarray(quest.CF)
    st = cfg.sample_time

    from simglucose_tpu.rl.policy import featurize_parts, iob_step

    def body(carry, _):
        s, prev, cgm_prev, iob = carry
        obs = featurize(prev, patient_basal, cgm_prev=cgm_prev, iob=iob)
        mu, _, _ = policy_apply(policy, obs)
        # policy_controller's residual_bb law (rl/evaluate.py)
        cgm = prev.observation.CGM
        meal_ann = prev.CHO
        bolus_u = (meal_ann * st) / cr + (cgm > 150.0).astype(mu.dtype) * (
            cgm - 140.0
        ) / cf
        bolus = jnp.where(meal_ann > 0, bolus_u / st, 0.0)
        rate = (patient_basal + bolus) * jnp.exp(scale * jnp.tanh(mu))
        s, r, cres = jax.vmap(partial(autoreset_step, cfg))(
            eparams, s, CtrlAction(basal=rate, bolus=jnp.zeros_like(rate))
        )
        n_cgm_prev = jnp.where(
            r.done, cres.observation.CGM, prev.observation.CGM
        )
        n_iob = jnp.where(
            r.done, jnp.zeros_like(iob),
            iob_step(iob, r.insulin, st),
        )
        return (s, cres, n_cgm_prev, n_iob), r

    (_, _, _, _), traj_e = jax.lax.scan(
        body,
        (state, res, res.observation.CGM,
         jnp.zeros_like(res.observation.CGM)),
        None, length=T,
    )

    np.testing.assert_allclose(
        np.asarray(traj_p["insulin"]), np.asarray(traj_e.insulin),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["BG"]), np.asarray(traj_e.BG), rtol=1e-5
    )
    # the meal bolus actually fired: the controller doses on the PREVIOUS
    # step's announced CHO (bb law), so the step AFTER the meal step
    # carries bolus-sized insulin even at the modulation floor exp(-1.1)
    ins = np.asarray(traj_p["insulin"])
    assert (ins[2] > 3.0 * np.asarray(patient_basal)).mean() > 0.9


def test_fused_mesh_state_compiles_once():
    """init_fused_state places every leaf (state planes over the batch
    axis, params/opt state/init flag/key replicated) exactly as the mesh
    train step returns it, so the second call reuses the first call's
    compilation instead of recompiling for new input shardings."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from simglucose_tpu.parallel.sharding import make_mesh
    from simglucose_tpu.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer

    mesh = make_mesh(dp=8, tp=1)
    Bs = 8 * 16
    _, params = make_env(cohort_names(Bs), batch=True, dtype=np.float32)
    packed = jax.device_put(
        pack_params(params.patient, basal_rate(params.patient)),
        NamedSharding(mesh, P(None, "dp")),
    )
    policy = _policy(4)
    cfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=2)
    ts = init_fused_state(
        policy, make_optimizer(cfg).init(policy), Bs, jax.random.PRNGKey(0),
        mesh=mesh,
    )
    loop = jax.jit(make_fused_train_loop(cfg, Bs, 1, hidden=H,
                                         interpret=True, mesh=mesh))
    with mesh:
        for _ in range(2):
            ts, m = loop(packed, ts)
    assert np.isfinite(np.asarray(m["reward_mean"])).all()
    assert loop._cache_size() == 1
