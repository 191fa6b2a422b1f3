"""Rollout engine: determinism, vmap==single equivalence, auto-reset."""
import jax
import jax.numpy as jnp
import numpy as np

from simglucose_tpu.controllers.functional import (
    bb_controller,
    bb_params,
    pid_controller,
)
from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.rollout import (
    batch_reset,
    broadcast_ctrl_state,
    make_batch_rollout_fn,
    rollout,
    rollout_batch,
)
from simglucose_tpu.params import load_quest_params

N = 40  # env steps per test rollout


def _bb(cfg, params, names):
    quest = load_quest_params(names, dtype=np.float64)
    quest = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), quest)
    bb = bb_params(params.patient, quest)
    return bb_controller(bb, cfg.sample_time)


def test_rollout_deterministic():
    cfg, params = make_env("adult#003", dtype=np.float64)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, dtype=jnp.float64)
    run = jax.jit(lambda k: rollout(cfg, params, k, ctrl0, ctrl, N))
    _, _, t1 = run(jax.random.PRNGKey(5))
    _, _, t2 = run(jax.random.PRNGKey(5))
    np.testing.assert_array_equal(np.asarray(t1.CGM), np.asarray(t2.CGM))
    _, _, t3 = run(jax.random.PRNGKey(6))
    assert not np.array_equal(np.asarray(t1.CGM), np.asarray(t3.CGM))


def test_vmap_batch_equals_single_closed_loop():
    """Analog of the reference's parallel==serial test
    (tests/test_sim_engine.py:24-86): a vmapped cohort rollout must equal
    each patient's individual rollout exactly."""
    names = ["adolescent#002", "adult#007", "child#005"]
    cfg, params = make_env(names, dtype=np.float64, batch=True)
    quest = jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64),
        load_quest_params(names, dtype=np.float64),
    )
    bb_all = bb_params(params.patient, quest)

    def one(p, bb, key):
        ctrl0, ctrl = bb_controller(bb, cfg.sample_time)
        return rollout(cfg, p, key, ctrl0, ctrl, N, start_min=jnp.int32(360))

    keys = jax.random.split(jax.random.PRNGKey(0), len(names))
    _, _, traj_b = jax.jit(jax.vmap(one))(params, bb_all, keys)

    for i in range(len(names)):
        p_i = jax.tree.map(lambda a: a[i], params)
        bb_i = jax.tree.map(lambda a: a[i], bb_all)
        _, _, traj_i = jax.jit(one)(p_i, bb_i, keys[i])
        for field in ("BG", "CGM", "CHO", "insulin"):
            np.testing.assert_array_equal(
                np.asarray(getattr(traj_b, field)[i]),
                np.asarray(getattr(traj_i, field)),
                err_msg=f"{names[i]}:{field}",
            )
        # the derived reward goes through log/power, which XLA fuses
        # differently under vmap — 1-ulp contract there
        np.testing.assert_allclose(
            np.asarray(traj_b.reward[i]),
            np.asarray(traj_i.reward),
            rtol=0,
            atol=1e-14,
            err_msg=f"{names[i]}:reward",
        )


def test_autoreset_batch_rollout():
    """Batched auto-reset engine: runs a cohort with a hypo-inducing PID
    controller; terminated episodes restart (episode_step drops back)."""
    names = cohort_names(8)
    cfg, params = make_env(names, dtype=np.float64, batch=True, random_init_bg=True)
    # aggressive positive basal on high glucose -> eventually done flags
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=0.05, dtype=jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    state, reset_res = batch_reset(cfg, params, keys)
    run = make_batch_rollout_fn(cfg, ctrl, n_steps=300, donate=False)
    final, last, traj = run(params, state, broadcast_ctrl_state(ctrl0, 8), reset_res)
    done = np.asarray(traj.done)
    assert done.any(), "expected at least one termination in 300 steps"
    # after a done, the env state belongs to a fresh episode
    steps = np.asarray(final.episode_step)
    assert steps.max() <= 300
    # BG stays finite and positive through resets
    assert np.isfinite(np.asarray(traj.BG)).all()
    assert (np.asarray(traj.BG) > 0).all()


def test_autoreset_carry_is_reset_observation():
    """After done, the next controller invocation must see the NEW episode's
    reset observation, not the terminal one (the reference gym wrapper hands
    the agent the fresh episode's obs after done, simglucose_gym_env.py:48-51).
    """
    import dataclasses

    from simglucose_tpu.core.types import CtrlAction
    from simglucose_tpu.envs.functional import env_reset, env_step
    from simglucose_tpu.envs.rollout import autoreset_step

    cfg, params = make_env("adolescent#001", dtype=np.float64)
    # force termination on the very first step
    cfg_done = dataclasses.replace(cfg, bg_done_low=1000.0)
    state, reset_res = env_reset(cfg, params, jax.random.PRNGKey(3), start_min=0)
    action = CtrlAction(basal=jnp.float64(0.01), bolus=jnp.float64(0.0))

    new_state, res, carry = jax.jit(
        lambda s, a: autoreset_step(cfg_done, params, s, a)
    )(state, action)
    assert bool(res.done), "bg_done_low=1000 must terminate immediately"
    # the recorded result keeps the terminal step
    _, term = jax.jit(lambda s, a: env_step(cfg_done, params, s, a))(state, action)
    assert float(res.observation.CGM) == float(term.observation.CGM)
    # the carry belongs to the new episode: fresh reset semantics
    assert not bool(carry.done)
    assert float(carry.reward) == 0.0
    assert float(carry.CHO) == 0.0 and float(carry.insulin) == 0.0
    assert float(carry.observation.CGM) != float(res.observation.CGM)
    assert int(new_state.episode_step) == 0

    # non-terminal step: carry is identical to the step result
    new_state2, res2, carry2 = jax.jit(
        lambda s, a: autoreset_step(cfg, params, s, a)
    )(state, action)
    assert not bool(res2.done)
    assert float(carry2.observation.CGM) == float(res2.observation.CGM)
    assert float(carry2.reward) == float(res2.reward)


def test_rollout_controller_sees_reset_obs_after_done():
    """Through make_batch_rollout_fn, the controller at step t+1 after a done
    at t receives the reset CGM — verified with a controller that records the
    observation it acted on."""
    import dataclasses

    from simglucose_tpu.core.types import CtrlAction

    cfg, params = make_env(
        ["adolescent#001"] * 2, dtype=np.float64, batch=True
    )
    cfg = dataclasses.replace(cfg, bg_done_low=1000.0)  # done every step

    def recording_ctrl(seen, result):
        # state = CGM the controller acted on this step
        return result.observation.CGM, CtrlAction(
            basal=jnp.float64(0.01), bolus=jnp.float64(0.0)
        )

    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    state, reset_res = batch_reset(cfg, params, keys, start_min=0)
    run = make_batch_rollout_fn(cfg, recording_ctrl, n_steps=3, donate=False)
    final, last, traj = run(
        params, state, jnp.zeros(2, jnp.float64), reset_res
    )
    done = np.asarray(traj.done)
    assert done.all()
    # every step terminated, so every post-step-0 controller obs must come
    # from a fresh episode's reset, never equal the previous terminal CGM
    cgm_terminal = np.asarray(traj.CGM)  # [T, B]
    cgm_carry = np.asarray(last.observation.CGM)
    assert (cgm_carry != cgm_terminal[-1]).all()


def test_random_init_bg_varies():
    cfg, params = make_env(
        ["adolescent#001"] * 4, dtype=np.float64, batch=True, random_init_bg=True
    )
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    state, reset_res = batch_reset(cfg, params, keys, start_min=0)
    bg0 = np.asarray(reset_res.BG)
    assert len(np.unique(bg0)) == 4  # all different initial BG


def test_wrap_reward_window60_compile_bounded():
    """Navigator (sample_time=1) gives the worst-case reward window, W=60:
    a reference-style 1-arg reward traces once per possible history length
    (60-branch lax.switch, envs/functional.wrap_reward_fn).  Contract: the
    switch is traced ONCE per program (scan body), and the whole rollout
    lowers+compiles within a small-multiple bound of the native 2-arg path
    (measured ~2.2s/2.8s vs ~1.0s/2.0s on CPU)."""
    import time

    from simglucose_tpu.analysis.risk import risk_diff_reward, risk_scalar
    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.functional import wrap_reward_fn
    from simglucose_tpu.envs.rollout import rollout_batch

    def risk_diff_1arg(BG_last_hour):
        if len(BG_last_hour) < 2:
            return 0.0
        _, _, rc = risk_scalar(BG_last_hour[-1])
        _, _, rp = risk_scalar(BG_last_hour[-2])
        return rp - rc

    B, T = 2, 8
    cfg, params = make_env(
        ["adolescent#001", "adult#001"], batch=True, sensor="Navigator",
        dtype=np.float32,
    )
    assert cfg.window_size == 60
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4)
    keys = jax.random.split(jax.random.PRNGKey(0), B)

    def build_time(rfw):
        f = jax.jit(
            lambda p, k: rollout_batch(cfg, p, k, ctrl0, ctrl, T, reward_fun=rfw)
        )
        t0 = time.time()
        f.lower(params, keys).compile()
        return time.time() - t0

    t_switch = build_time(wrap_reward_fn(risk_diff_1arg, cfg.window_size))
    # generous absolute bound: catches a regression to per-step retracing
    # (which would be ~T x worse) while staying robust to slow CI boxes
    assert t_switch < 60.0, f"W=60 switch build took {t_switch:.1f}s"
