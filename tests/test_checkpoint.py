"""Checkpoint/resume: a resumed rollout must continue bit-identically."""
import numpy as np
import jax

from simglucose_tpu.controllers.functional import pid_controller
from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.rollout import (
    batch_reset,
    broadcast_ctrl_state,
    make_batch_rollout_fn,
)
from simglucose_tpu.utils.checkpoint import (
    CheckpointManager,
    restore_state,
    save_state,
)


def test_save_restore_roundtrip(tmp_path):
    B = 4
    cfg, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys)
    p = str(tmp_path / "state.npz")
    save_state(p, state)
    state2 = restore_state(p, state)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(state2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_continues_identically(tmp_path):
    B, T = 4, 8
    cfg, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4)
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    state, res = batch_reset(cfg, params, keys)
    ctrl_state = broadcast_ctrl_state(ctrl0, B)
    run = make_batch_rollout_fn(cfg, ctrl, n_steps=T, donate=False)

    # straight-through: 2T steps
    s1, last1, tr1 = run(params, state, ctrl_state, res)
    s_cont, last_cont, tr_cont = run(params, s1, ctrl_state, last1)

    # checkpointed: save after T, restore, continue
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(T, (s1, last1))
    s_r, last_r = mgr.restore(like=(s1, last1))
    s2, last2, tr2 = run(params, s_r, ctrl_state, last_r)

    np.testing.assert_array_equal(
        np.asarray(tr_cont.BG), np.asarray(tr2.BG)
    )
    np.testing.assert_array_equal(
        np.asarray(tr_cont.CGM), np.asarray(tr2.CGM)
    )


def test_restore_casts_to_like_dtypes(tmp_path):
    """An f32 checkpoint restored against an f64 `like` comes back in the
    session's dtypes."""
    import jax.numpy as jnp

    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "n": np.int32(7)}
    p = str(tmp_path / "ck.npz")
    save_state(p, tree)
    like = {"w": jnp.zeros((2, 3), jnp.float64), "n": jnp.int64(0)}
    out = restore_state(p, like)
    assert out["w"].dtype == np.float64
    assert out["n"].dtype == np.int64
    np.testing.assert_allclose(np.asarray(out["w"]), tree["w"])


def test_restore_rejects_shape_mismatch(tmp_path):
    import pytest

    tree = {"w": np.zeros((2, 3), np.float32)}
    p = str(tmp_path / "ck.npz")
    save_state(p, tree)
    with pytest.raises(ValueError, match="shape"):
        restore_state(p, {"w": np.zeros((4, 3), np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        restore_state(p, {"w": np.zeros((2, 3), np.float32), "x": np.zeros(2)})


def test_manager_rolling(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    tree = {"a": np.arange(3), "b": np.float32(1.5)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    out = mgr.restore(like=tree)
    np.testing.assert_array_equal(out["a"], tree["a"])


def test_manager_orbax_backend(tmp_path):
    """The orbax backend round-trips pytrees and prunes old steps."""
    import jax.numpy as jnp

    mgr = CheckpointManager(str(tmp_path), max_to_keep=2, backend="orbax")
    tree = {"a": jnp.arange(3.0), "b": jnp.float32(1.5)}
    for s in (1, 2, 3):
        mgr.save(s, {"a": tree["a"] + s, "b": tree["b"]})
    assert mgr.all_steps() == [2, 3]
    out = mgr.restore(like=tree)
    np.testing.assert_array_equal(np.asarray(out["a"]), np.arange(3.0) + 3)
    out2 = mgr.restore(like=tree, step=2)
    np.testing.assert_array_equal(np.asarray(out2["a"]), np.arange(3.0) + 2)


def test_orbax_sharded_fused_trainstate_roundtrip(tmp_path):
    """Orbax round-trip of a mesh-sharded FusedTrainState: save sharded ->
    restore -> re-shard -> the next fused train step is BIT-equal to the
    uncheckpointed one."""
    import jax.numpy as jnp

    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import pack_params
    from simglucose_tpu.parallel.sharding import make_mesh
    from simglucose_tpu.rl.fused import init_fused_state, make_fused_train_step
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(dp=8, tp=1)
    B = 8 * 128
    _, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
    packed = jax.device_put(
        pack_params(params.patient, basal_rate(params.patient)),
        NamedSharding(mesh, P(None, "dp")),
    )
    cfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=2)
    policy = init_policy(
        jax.random.PRNGKey(1), hidden=16, act="relu", init_mu_bias=-2.2,
        init_log_std=cfg.init_log_std,
    )
    ts = init_fused_state(
        policy, make_optimizer(cfg).init(policy), B, jax.random.PRNGKey(0),
        mesh=mesh,
    )
    step = make_fused_train_step(
        cfg, B, hidden=16, interpret=True, mesh=mesh,
    )
    with mesh:
        ts1, _ = step(packed, ts)  # advance once so the state is nontrivial

    mgr = CheckpointManager(str(tmp_path), backend="orbax")
    mgr.save(1, ts1)
    host_like = jax.tree.map(np.asarray, ts1)
    restored = mgr.restore(like=host_like)
    # re-shard exactly like init_fused_state lays the planes out
    shard = NamedSharding(mesh, P(None, "dp"))
    rep = NamedSharding(mesh, P())
    restored = restored._replace(
        state_f=jax.device_put(jnp.asarray(restored.state_f), shard),
        state_i=jax.device_put(jnp.asarray(restored.state_i), shard),
        params=jax.device_put(
            jax.tree.map(jnp.asarray, restored.params), rep
        ),
        opt_state=jax.device_put(
            jax.tree.map(jnp.asarray, restored.opt_state), rep
        ),
        init=jnp.asarray(restored.init),
        key=jnp.asarray(restored.key),
    )
    with mesh:
        ts2a, ma = step(packed, ts1)
        ts2b, mb = step(packed, restored)
    for a, b in zip(jax.tree.leaves(ts2a), jax.tree.leaves(ts2b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k in ma:
        np.testing.assert_array_equal(np.asarray(ma[k]), np.asarray(mb[k]))


def test_migrate_legacy_opt_state():
    """Pre-flatten optimizer-state checkpoints resume exactly: restore
    against legacy_optimizer(cfg).init(params) and convert with
    migrate_opt_state — the migrated state produces the SAME next update
    as an optimizer that had been flattened all along."""
    import jax
    import jax.numpy as jnp
    import optax

    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import (
        PPOConfig,
        legacy_optimizer,
        make_optimizer,
        migrate_opt_state,
    )

    cfg = PPOConfig(lr=1e-2)
    params = init_policy(jax.random.PRNGKey(0), act="relu")
    grads = jax.tree.map(
        lambda a: jnp.full_like(a, 0.01) + 0.1 * a, params
    )

    # a run that trained 3 steps on the legacy (unflattened) optimizer
    leg_opt = legacy_optimizer(cfg)
    leg_state = leg_opt.init(params)
    leg_params = params
    for _ in range(3):
        u, leg_state = leg_opt.update(grads, leg_state, leg_params)
        leg_params = optax.apply_updates(leg_params, u)

    # the same run on the current flattened optimizer
    new_opt = make_optimizer(cfg)
    new_state = new_opt.init(params)
    new_params = params
    for _ in range(3):
        u, new_state = new_opt.update(grads, new_state, new_params)
        new_params = optax.apply_updates(new_params, u)

    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7),
        leg_params, new_params,
    )

    # migrate, then take one MORE step on each and require identical params
    migrated = migrate_opt_state(leg_state, leg_params, cfg)
    u_m, _ = new_opt.update(grads, migrated, leg_params)
    p_m = optax.apply_updates(leg_params, u_m)
    u_n, _ = new_opt.update(grads, new_state, new_params)
    p_n = optax.apply_updates(new_params, u_n)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7),
        p_m, p_n,
    )
