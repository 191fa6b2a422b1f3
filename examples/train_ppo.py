"""On-device PPO training over a sharded patient cohort — the on-device
analog of the reference's rllab DDPG example (reference examples/run_rllab.py),
re-designed as a single-program actor-learner (see simglucose_tpu/rl/ppo.py).
"""
import jax
import numpy as np

from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.rollout import batch_reset
from simglucose_tpu.parallel.sharding import make_mesh, replicate, shard_batch
from simglucose_tpu.rl.policy import init_policy
from simglucose_tpu.rl.ppo import (
    PPOConfig,
    TrainState,
    make_optimizer,
    make_train_step,
)

B = 256  # patients (shard over all available devices)
ITERS = 20

cfg, env_params = make_env(
    cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32
)
key = jax.random.PRNGKey(0)
env_state, reset_res = batch_reset(cfg, env_params, jax.random.split(key, B))

ppo_cfg = PPOConfig(rollout_steps=64, epochs=2, minibatches=4)
policy = init_policy(
    jax.random.fold_in(key, 1), init_log_std=ppo_cfg.init_log_std
)
opt_state = make_optimizer(ppo_cfg).init(policy)

n_dev = len(jax.devices())
mesh = make_mesh(dp=n_dev, tp=1) if n_dev > 1 else None
if mesh is not None:
    env_params = shard_batch(env_params, mesh)
    env_state = shard_batch(env_state, mesh)
    reset_res = shard_batch(reset_res, mesh)
    policy = replicate(policy, mesh)
    opt_state = replicate(opt_state, mesh)

ts = TrainState(
    params=policy,
    opt_state=opt_state,
    env_state=env_state,
    prev_res=reset_res,
    key=key,
)
train_step = jax.jit(make_train_step(ppo_cfg, cfg, mesh=mesh))

for it in range(ITERS):
    ts, metrics = train_step(env_params, ts)
    print(
        f"iter {it:3d}  reward={float(metrics['reward_mean']):+.4f}  "
        f"done%={100 * float(metrics['done_frac']):.2f}  "
        f"pg={float(metrics['pg_loss']):+.4f}  "
        f"v={float(metrics['v_loss']):.4f}"
    )
