#!/usr/bin/env python
"""Time the rollout kernel (and optionally the XLA rollout) on the GPU.

For each batch and each ``block:num_warps`` pair: compile time, device
memory of the compiled call, and env-steps/s of the stochastic PID config
(Dexcom, auto-reset, random scenario), law-gated so a fast wrong kernel
fails.  ``--controller nn`` times the fused actor's config instead (relu
MLP policy, sampled actions).  ``--xla`` adds make_batch_rollout_fn on the
same config.  One JSON line per measurement.

Usage: python tools/bench_pallas.py [--batches 4096,65536] [--steps 480]
           [--blocks 128:4,64:2] [--controller pid|nn] [--xla] [--reps 5]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def main():
    from simglucose_tpu.analysis.laws import PID_BANDS, check_bands, law_stats
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import (
        config_for_sensor,
        make_pallas_rollout,
        pack_params,
        pack_policy_weights,
    )
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.utils.runtime import (
        device_record,
        gpu_name_and_power,
        use_compile_cache,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="4096,65536")
    ap.add_argument("--steps", type=int, default=480)
    ap.add_argument("--blocks", default="128:4")
    ap.add_argument("--controller", default="pid", choices=("pid", "nn"))
    ap.add_argument("--xla", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    use_compile_cache()
    dev = {**device_record(), "gpu": gpu_name_and_power()}
    if dev["platform"] != "gpu":
        sys.exit(f"bench_pallas: no GPU (platform {dev['platform']!r})")
    T = args.steps

    def emit(**row):
        print(json.dumps({**row, "device": dev}), flush=True)

    for B in (int(b) for b in args.batches.split(",")):
        _, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
        packed = pack_params(params.patient, basal_rate(params.patient))
        kw = {}
        if args.controller == "nn":
            pol = init_policy(jax.random.PRNGKey(0), hidden=64, act="relu",
                              init_mu_bias=-2.2)
            kw["weights"] = pack_policy_weights(pol)
        for spec in args.blocks.split(","):
            block, warps = (int(x) for x in spec.split(":"))
            cfg = config_for_sensor(
                "Dexcom", controller=args.controller, n_steps=T, block=block,
                num_warps=warps,
            )
            run = make_pallas_rollout(cfg, B)
            tic = time.perf_counter()
            fn = jax.jit(lambda p, s, **k: run(p, s, **k)).lower(
                packed, 0, **kw).compile()
            t_compile = time.perf_counter() - tic
            traj = jax.block_until_ready(fn(packed, 0, **kw))
            tic = time.perf_counter()
            for i in range(args.reps):
                traj = fn(packed, i + 1, **kw)
            jax.block_until_ready(traj)
            sec = (time.perf_counter() - tic) / args.reps
            stats = law_stats(traj, cfg.sample_time)
            if args.controller == "pid":
                check_bands(stats, PID_BANDS, f"B={B} block={block}")
            emit(path="kernel", controller=args.controller, B=B, T=T,
                 block=block, num_warps=warps, compile_s=t_compile,
                 call_s=sec, steps_per_s=B * T / sec,
                 temp_bytes=int(fn.memory_analysis().temp_size_in_bytes),
                 laws=stats)
        if args.xla:
            from simglucose_tpu.controllers.functional import pid_controller
            from simglucose_tpu.envs.rollout import (
                batch_reset,
                broadcast_ctrl_state,
                make_batch_rollout_fn,
            )

            ecfg, eparams = make_env(cohort_names(B), batch=True,
                                     random_init_bg=True, dtype=np.float32)
            ctrl0, ctrl = pid_controller(ecfg.sample_time, P=-1e-4, I=-1e-7)
            state, rst = jax.jit(lambda p, k: batch_reset(ecfg, p, k))(
                eparams, jax.random.split(jax.random.PRNGKey(0), B))
            xrun = make_batch_rollout_fn(ecfg, ctrl, n_steps=T, donate=False,
                                         reset_cadence=8)
            cs = broadcast_ctrl_state(ctrl0, B)
            tic = time.perf_counter()
            jax.block_until_ready(xrun(eparams, state, cs, rst))
            t_first = time.perf_counter() - tic
            tic = time.perf_counter()
            for _ in range(args.reps):
                out = xrun(eparams, state, cs, rst)
            jax.block_until_ready(out)
            sec = (time.perf_counter() - tic) / args.reps
            emit(path="xla", controller="pid", B=B, T=T, first_call_s=t_first,
                 call_s=sec, steps_per_s=B * T / sec)


if __name__ == "__main__":
    main()
