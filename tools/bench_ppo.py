#!/usr/bin/env python
"""PPO training throughput — BASELINE config 4 (on-device RL training).

Measures the full jitted PPO iteration (rollout of B auto-resetting envs
for rollout_steps + GAE + epochs x minibatch clipped-surrogate updates —
simglucose_tpu/rl/ppo.py) on the default backend (a GPU when present), and
reports env-steps/s and iterations/s.

The analog of the reference's rllab DDPG training config
(reference: examples/run_rllab.py:1-43) at cohort scale.

Prints ONE JSON line:
  {"metric": "ppo_env_steps_per_sec", "value": N, "unit": "steps/s",
   "iters_per_sec": N, "batch": B, "rollout_steps": T}
"""
import json
import sys
import time

import jax
import numpy as np

sys.path.insert(0, ".")  # run as `python tools/bench_ppo.py` from repo root

from simglucose_tpu.utils.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

B = 8192
N_ITERS = 8


def main():
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import batch_reset
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import (
        PPOConfig,
        TrainState,
        make_optimizer,
        make_train_step,
    )

    cfg, env_params = make_env(
        cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32
    )
    key = jax.random.PRNGKey(0)
    env_state, reset_res = batch_reset(cfg, env_params, jax.random.split(key, B))
    ppo_cfg = PPOConfig(rollout_steps=64, epochs=2, minibatches=4)
    policy = init_policy(
        jax.random.fold_in(key, 1), init_log_std=ppo_cfg.init_log_std
    )
    ts = TrainState(
        params=policy,
        opt_state=make_optimizer(ppo_cfg).init(policy),
        env_state=env_state,
        prev_res=reset_res,
        key=key,
    )
    step = jax.jit(make_train_step(ppo_cfg, cfg), donate_argnums=(1,))

    ts, m = jax.block_until_ready(step(env_params, ts))  # compile + warm

    # best-of-2 timed rounds
    best = 0.0
    for _ in range(2):
        tic = time.perf_counter()
        for _ in range(N_ITERS):
            ts, m = step(env_params, ts)
        jax.block_until_ready(ts)
        toc = time.perf_counter()
        assert np.isfinite(float(m["reward_mean"]))
        best = max(best, N_ITERS / (toc - tic))
    print(
        json.dumps(
            {
                "metric": "ppo_env_steps_per_sec",
                "value": round(best * B * ppo_cfg.rollout_steps),
                "unit": "steps/s",
                "iters_per_sec": round(best, 3),
                "batch": B,
                "rollout_steps": ppo_cfg.rollout_steps,
            }
        )
    )


if __name__ == "__main__":
    main()
