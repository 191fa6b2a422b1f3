"""Device-mesh sharding tests on the virtual 8-device CPU mesh.

The analog of the reference's parallel==serial contract
(reference: tests/test_sim_engine.py:24-86): a cohort rollout sharded over
the mesh must equal the unsharded one.
"""
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
from simglucose_tpu.parallel.sharding import (
    batch_sharding,
    gather_to_host,
    make_mesh,
    replicate,
    shard_batch,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest should provide 8 CPU devices"
    return make_mesh(dp=8, tp=1)


def _setup(B):
    cfg, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys)
    return cfg, params, ctrl0, ctrl, state, res


def test_sharded_rollout_equals_unsharded(mesh):
    B, T = 16, 8
    cfg, params, ctrl0, ctrl, state, res = _setup(B)
    cs = broadcast_ctrl_state(ctrl0, B)
    run = make_batch_rollout_fn(cfg, ctrl, n_steps=T, donate=False)

    _, _, traj_ref = run(params, state, cs, res)

    params_s = shard_batch(params, mesh)
    state_s = shard_batch(state, mesh)
    res_s = shard_batch(res, mesh)
    cs_s = shard_batch(cs, mesh)
    _, _, traj_sh = run(params_s, state_s, cs_s, res_s)

    np.testing.assert_allclose(
        np.asarray(traj_ref.BG), np.asarray(traj_sh.BG), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_ref.CGM), np.asarray(traj_sh.CGM), rtol=1e-6
    )


def test_sharding_placement(mesh):
    B = 16
    cfg, params, *_ = _setup(B)
    params_s = shard_batch(params, mesh)
    sh = params_s.patient.BW.sharding
    assert sh.is_equivalent_to(batch_sharding(mesh), ndim=1)
    # each device holds B/8 patients
    assert params_s.patient.BW.addressable_shards[0].data.shape == (B // 8,)


def test_gather_to_host(mesh):
    B = 8
    cfg, params, *_ = _setup(B)
    params_s = shard_batch(params, mesh)
    host = gather_to_host(params_s)
    np.testing.assert_array_equal(
        host.patient.BW, np.asarray(params.patient.BW)
    )


def test_replicate(mesh):
    x = {"w": np.arange(6.0)}
    r = replicate(x, mesh)
    assert r["w"].sharding.is_fully_replicated


def test_tp2_learner_gradient_parity():
    """One full PPO train step on a dp=4 x tp=2 mesh must produce the same
    updated params as dp=8 x tp=1 at hidden=64: the tp
    sharding (activation constraints + GSPMD all-reduces) is a layout
    choice, not a numerics choice — threefry rollout/shuffle randomness is
    mesh-independent."""
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import (
        PPOConfig,
        TrainState,
        make_optimizer,
        make_train_step,
    )

    B = 16
    cfg, params = make_env(
        cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32
    )
    key = jax.random.PRNGKey(0)
    state, res = batch_reset(cfg, params, jax.random.split(key, B))
    ppo_cfg = PPOConfig(rollout_steps=4, epochs=1, minibatches=2)
    policy = init_policy(jax.random.fold_in(key, 1), hidden=64)
    opt_state = make_optimizer(ppo_cfg).init(policy)

    updated = {}
    for tag, (dp, tp) in {"tp2": (4, 2), "tp1": (8, 1)}.items():
        m = make_mesh(dp=dp, tp=tp)
        ts = TrainState(
            params=replicate(policy, m),
            opt_state=replicate(opt_state, m),
            env_state=shard_batch(state, m),
            prev_res=shard_batch(res, m),
            key=replicate(key, m),
        )
        step = jax.jit(make_train_step(ppo_cfg, cfg, mesh=m))
        with m:
            ts2, metrics = step(shard_batch(params, m), ts)
        assert np.isfinite(float(metrics["reward_mean"]))
        updated[tag] = jax.tree.leaves(ts2.params)
    for a, b in zip(updated["tp2"], updated["tp1"]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-6
        )
