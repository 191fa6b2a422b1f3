#!/usr/bin/env python
"""Fused PPO training throughput — BASELINE config 4 via the kernel actor.

Measures the fused PPO iteration (rl/fused.py: the rollout kernel with the
policy MLP inside it + XLA learner) on the GPU, and
reports env-steps/s and iterations/s.  Compare tools/bench_ppo.py (the
XLA-scan rollout trainer).

Prints ONE JSON line:
  {"metric": "fused_ppo_env_steps_per_sec", "value": N, "unit": "steps/s",
   "iters_per_sec": N, "batch": B, "rollout_steps": T}
"""
import json
import sys
import time

import jax
import numpy as np

sys.path.insert(0, ".")  # run as `python tools/bench_ppo_fused.py` from repo root

from simglucose_tpu.utils.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

B = 8192
T = 64
N_ITERS = 32


def main():
    sys.path.insert(0, ".")
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import pack_params
    from simglucose_tpu.rl.fused import (
        init_fused_state,
        make_fused_train_loop,
    )
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer

    _, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    key = jax.random.PRNGKey(0)
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=4)
    hidden = 64
    policy = init_policy(
        jax.random.fold_in(key, 1), hidden=hidden, act="relu",
        init_log_std=cfg.init_log_std, init_mu_bias=-2.2,
    )
    ts = init_fused_state(policy, make_optimizer(cfg).init(policy), B, key)
    # measure through the scanned train loop (N_ITERS iterations per
    # dispatch), the form production training runs
    loop = jax.jit(
        make_fused_train_loop(cfg, B, N_ITERS, hidden=hidden),
        donate_argnums=(1,),
    )

    ts, m = jax.block_until_ready(loop(packed, ts))  # compile + warm

    best = 0.0
    for _ in range(2):
        tic = time.perf_counter()
        ts, m = jax.block_until_ready(loop(packed, ts))
        toc = time.perf_counter()
        assert np.isfinite(float(m["reward_mean"][-1]))
        best = max(best, N_ITERS / (toc - tic))
    print(
        json.dumps(
            {
                "metric": "fused_ppo_env_steps_per_sec",
                "value": round(best * B * T),
                "unit": "steps/s",
                "iters_per_sec": round(best, 3),
                "batch": B,
                "rollout_steps": T,
            }
        )
    )


if __name__ == "__main__":
    main()
