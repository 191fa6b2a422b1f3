#!/usr/bin/env python
"""Headline benchmark: env-steps/s on one GPU at a 4096-patient batch,
plus the fused-PPO training throughput (BASELINE config 4).

Config 3 of BASELINE.json: 4096 auto-resetting patients with native CGM
noise, random meal scenarios, risk-diff reward, PID controller.  One env
step = sample_time (3) patient-minutes: pump quantization, scenario
lookup, RK4 ODE integration, CGM sampling, risk/reward/termination.

The headline path is the rollout kernel (simglucose_tpu/ops/pallas_rollout.py,
Pallas through Triton): the whole closed-loop simulator as one GPU kernel,
state in registers for the whole rollout.  Its deterministic config
matches the XLA env path and its stochastic config is distribution-
validated against it (tests/test_pallas_rollout.py, BASELINE.md).  The XLA
scan path is timed on the same config beside it.  Nothing falls back: a
failure of either path fails the bench.

LAW ASSERTIONS: every bench run regression-tests the benched configuration
against the distributional invariants in simglucose_tpu/analysis/laws.py
(PID config: BG mean band, done rate band, CGM-BG residual std near the
Johnson-SU scale, CHO/day band — reference laws sensor/noise_gen.py:15-69,
scenario_gen.py:33-60).  A kernel regression that clamps BG, drops meals,
or zeroes the noise FAILS the bench instead of posting a fast wrong number.

The fused-PPO section times the full training iteration (the kernel's 'nn'
actor with the policy MLP inside the kernel + the XLA learner,
rl/fused.py) through the scanned train loop — the analog of the
reference's only end-to-end RL run (examples/run_rllab.py:1-43).

Timing: every timed region ends in ``jax.block_until_ready``.

Prints ONE JSON line:
  {"metric": "env_steps_per_sec", "value": N, "unit": "steps/s",
   "vs_baseline": N/1e6, "path": "pallas", "xla_env_steps_per_sec": X,
   "fused_ppo_steps_per_sec": M, "fused_ppo_iters_per_sec": I,
   "device": {"platform", "kind", "count", "gpu"}}
vs_baseline is against the 1M env-steps/s/host north star (BASELINE.md).
"""
import json
import sys
import time

import jax
import numpy as np

from simglucose_tpu.analysis.laws import (
    PID_BANDS,
    SENSOR_BANDS,
    check_bands,
    law_stats,
)
from simglucose_tpu.utils.runtime import (
    device_record,
    gpu_name_and_power,
    use_compile_cache,
)

B = 4096
ROLL_T, ROLL_CALLS = 4096, 24  # kernel rollout: steps per call, timed calls
XLA_T, XLA_CALLS = 256, 8  # XLA rollout

# Fused PPO training config (tools/bench_ppo_fused.py, BASELINE config 4);
# PPO_ITERS iterations per scanned-loop dispatch.
PPO_B = 8192
PPO_T = 64
PPO_ITERS = 128


def law_gate_other_sensors():
    """Short stochastic rollouts at st=5 (GuardianRT) and st=1
    (Navigator), gated against SENSOR_BANDS: sample_time changes the
    noise-lattice cadence, where a kernel bug would hide."""
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import (
        config_for_sensor,
        make_pallas_rollout,
        pack_params,
    )

    Bs, T = 1024, 576
    _, params = make_env(cohort_names(Bs), batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    for sensor, bands in SENSOR_BANDS.items():
        cfg = config_for_sensor(sensor, controller="pid", n_steps=T)
        traj = jax.jit(make_pallas_rollout(cfg, Bs))(packed, 11)
        check_bands(law_stats(traj, cfg.sample_time), bands, sensor)


def bench_pallas():
    """The rollout kernel.  On multi-device backends it runs under
    shard_map over a dp mesh — one kernel instance per device, zero
    rollout communication; the global batch scales with the device count
    at a fixed per-device batch of 4096."""
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import (
        PallasRolloutConfig,
        make_pallas_rollout,
        make_sharded_pallas_rollout,
        pack_params,
    )

    T, n_calls = ROLL_T, ROLL_CALLS
    n_dev = jax.device_count()
    Bg = B * n_dev  # global batch: 4096 per device

    _, params = make_env(cohort_names(Bg), batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    pcfg = PallasRolloutConfig(n_steps=T, controller="pid")
    if n_dev > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from simglucose_tpu.parallel.sharding import make_mesh

        mesh = make_mesh(dp=n_dev, tp=1)
        packed = jax.device_put(packed, NamedSharding(mesh, P(None, "dp")))
        run = jax.jit(make_sharded_pallas_rollout(pcfg, Bg, mesh))
    else:
        packed = jax.device_put(packed)
        run = jax.jit(make_pallas_rollout(pcfg, Bg))

    traj = jax.block_until_ready(run(packed, 0))  # compile + warm

    # two timed rounds, best-of
    best = 0.0
    for r in range(2):
        tic = time.perf_counter()
        for i in range(n_calls):
            traj = run(packed, r * n_calls + i + 1)
        jax.block_until_ready(traj)
        best = max(best, Bg * T * n_calls / (time.perf_counter() - tic))
    assert np.isfinite(np.asarray(traj["reward"][-1])).all()

    # law regression gate on the exact benched configuration: a violation
    # fails the bench rather than posting a headline
    check_bands(law_stats(traj, pcfg.sample_time), PID_BANDS, "bench")
    return best


def bench_fused_ppo():
    """Fused PPO training iteration (BASELINE config 4): the kernel's 'nn'
    actor (policy MLP inside the kernel, persistent episode state) + XLA
    learner, B=8192, T=64, epochs=2, mb=4, measured through the scanned
    train loop (make_fused_train_loop — one dispatch per PPO_ITERS
    iterations)."""
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import pack_params
    from simglucose_tpu.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer

    _, params = make_env(cohort_names(PPO_B), batch=True, dtype=np.float32)
    packed = pack_params(params.patient, basal_rate(params.patient))
    key = jax.random.PRNGKey(0)
    cfg = PPOConfig(rollout_steps=PPO_T, epochs=2, minibatches=4)
    hidden = 64
    policy = init_policy(
        jax.random.fold_in(key, 1), hidden=hidden, act="relu",
        init_log_std=cfg.init_log_std, init_mu_bias=-2.2,
    )
    ts = init_fused_state(policy, make_optimizer(cfg).init(policy), PPO_B, key)
    loop = jax.jit(
        make_fused_train_loop(cfg, PPO_B, PPO_ITERS, hidden=hidden),
        donate_argnums=(1,),
    )

    ts, m = jax.block_until_ready(loop(packed, ts))  # compile + warm

    best = 0.0
    for _ in range(2):
        tic = time.perf_counter()
        ts, m = jax.block_until_ready(loop(packed, ts))
        best = max(best, PPO_ITERS / (time.perf_counter() - tic))
    # training-side sanity: every iteration produced finite metrics
    for k, v in m.items():
        assert np.isfinite(np.asarray(v)).all(), f"non-finite metric {k}"
    return best * PPO_B * PPO_T, best


def bench_xla():
    """General path: jit(vmap(scan(env_step))) rollout engine, same
    config (PID, auto-reset, Dexcom)."""
    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_rollout_fn,
    )

    T, n_calls = XLA_T, XLA_CALLS

    cfg, params = make_env(
        cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32
    )
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, reset_res = jax.jit(lambda p, k: batch_reset(cfg, p, k))(params, keys)
    ctrl_state = broadcast_ctrl_state(ctrl0, B)

    # reset_cadence amortizes the per-step reset-candidate + midnight-regen
    # sampling over 16-step chunks (trajectory-exact for surviving lanes;
    # tests/test_rollout_cadence.py)
    run = make_batch_rollout_fn(
        cfg, ctrl, n_steps=T, donate=True, reset_cadence=16
    )

    state, last, traj = jax.block_until_ready(
        run(params, state, ctrl_state, reset_res)
    )
    tic = time.perf_counter()
    for _ in range(n_calls):
        state, last, traj = run(params, state, ctrl_state, last)
    jax.block_until_ready(traj)
    sps = B * T * n_calls / (time.perf_counter() - tic)
    assert np.isfinite(np.asarray(traj.reward[-1])).all()
    return sps


def main():
    use_compile_cache()
    dev = device_record()
    if dev["platform"] != "gpu":
        sys.exit(f"bench: JAX found no GPU (platform {dev['platform']!r})")
    sps = bench_pallas()
    law_gate_other_sensors()
    fused_sps, fused_ips = bench_fused_ppo()
    out = {
        "metric": "env_steps_per_sec",
        "value": round(sps),
        "unit": "steps/s",
        "vs_baseline": round(sps / 1e6, 3),
        "path": "pallas",
        "xla_env_steps_per_sec": round(bench_xla()),
        "fused_ppo_steps_per_sec": round(fused_sps),
        "fused_ppo_iters_per_sec": round(fused_ips, 3),
        "fused_ppo_batch": PPO_B,
        "fused_ppo_rollout_steps": PPO_T,
        "device": {**dev, "gpu": gpu_name_and_power()},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
