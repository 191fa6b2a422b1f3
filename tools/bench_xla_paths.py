#!/usr/bin/env python
"""Measure the general XLA rollout paths on the GPU: streaming vs pregen
(fixed-horizon) and autoreset scan-unroll variants.

The fixed-horizon engine is simulate()'s XLA path (the reference's
batch_sim hot loop, sim_engine.py:33-37,65-76); the autoreset engine is
the RL/bench path.  Used to calibrate bench.py's XLA numbers and the
BASELINE.md table.
"""
import sys
import time

import jax
import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from simglucose_tpu.utils.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

from simglucose_tpu.controllers.functional import pid_controller  # noqa: E402
from simglucose_tpu.envs.build import cohort_names, make_env  # noqa: E402
from simglucose_tpu.envs.rollout import (  # noqa: E402
    batch_reset,
    broadcast_ctrl_state,
    make_batch_rollout_fn,
    rollout_batch,
)

B = 4096
T = 256


def timeit(fn, n_calls=8):
    jax.block_until_ready(fn())  # compile + warm
    tic = time.perf_counter()
    for _ in range(n_calls):
        out = fn()
    jax.block_until_ready(out)
    return B * T * n_calls / (time.perf_counter() - tic)


def bench_fixed(pregen):
    cfg, params = make_env(
        cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32
    )
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    run = jax.jit(
        lambda: rollout_batch(
            cfg, params, keys, ctrl0, ctrl, T, start_min=600, pregen=pregen
        )
    )
    return timeit(run)


def bench_autoreset(reset_cadence=1):
    cfg, params = make_env(
        cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32
    )
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, reset_res = jax.jit(lambda p, k: batch_reset(cfg, p, k))(params, keys)
    cs = broadcast_ctrl_state(ctrl0, B)
    run = make_batch_rollout_fn(
        cfg, ctrl, n_steps=T, donate=False, reset_cadence=reset_cadence
    )

    return timeit(lambda: run(params, state, cs, reset_res))


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "fixed"):
        s = bench_fixed(pregen=False)
        print(f"fixed_streaming: {s/1e6:.2f}M steps/s", flush=True)
        s = bench_fixed(pregen=True)
        print(f"fixed_pregen:    {s/1e6:.2f}M steps/s", flush=True)
    if which in ("all", "autoreset"):
        s = bench_autoreset()
        print(f"autoreset:       {s/1e6:.2f}M steps/s", flush=True)
        for K in (16, 64):
            s = bench_autoreset(reset_cadence=K)
            print(f"autoreset K={K:3d}: {s/1e6:.2f}M steps/s", flush=True)


if __name__ == "__main__":
    main()
