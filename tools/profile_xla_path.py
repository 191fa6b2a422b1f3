#!/usr/bin/env python
"""Ablation profile of the general XLA rollout path (bench.py bench_xla).

The XLA `jit(scan(vmap))` engine runs each env step as many small fusions;
this tool measures which step component costs what, by toggling them:

  base       full PID config (native noise + random scenario + autoreset)
  noise-off  exogenous zero noise (no threefry AR(1)/Johnson chain)
  scen-none  scenario_mode='none' (no per-step daily-plan candidate draw)
  both-off   both of the above
  fixedhz    fixed-horizon rollout (no autoreset reset-branch)

Prints one JSON line of steps/s per variant, with the device record.
Run on the GPU; results feed the XLA-path notes in PERF.md.
"""
import json
import sys
import time

import jax
import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from simglucose_tpu.utils.runtime import (  # noqa: E402
    device_record,
    use_compile_cache,
)

use_compile_cache()

B = 4096
T = 256
N_CALLS = 8


def measure(cfg_kwargs, env_kwargs=None, fixed=False):
    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_continue_fn,
        make_batch_rollout_fn,
    )

    cfg, params = make_env(
        cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32,
        **(env_kwargs or {}), **cfg_kwargs,
    )
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, reset_res = jax.jit(lambda p, k: batch_reset(cfg, p, k))(params, keys)
    ctrl_state = broadcast_ctrl_state(ctrl0, B)

    if fixed:
        run0 = make_batch_continue_fn(cfg, ctrl, T)

        def run(params, state, cs, last):
            s, c, l, traj = run0(params, state, cs, last)
            return s, l, traj
    else:
        run = make_batch_rollout_fn(cfg, ctrl, n_steps=T, donate=True)

    state, last, traj = jax.block_until_ready(
        run(params, state, ctrl_state, reset_res)
    )
    tic = time.perf_counter()
    for _ in range(N_CALLS):
        state, last, traj = run(params, state, ctrl_state, last)
    jax.block_until_ready(traj)
    toc = time.perf_counter()
    assert np.isfinite(np.asarray(traj.reward[-1])).all()
    return B * T * N_CALLS / (toc - tic)


def main():
    zero_noise = np.zeros(T * N_CALLS * 4 + 64, np.float32)
    variants = {
        "base": dict(cfg_kwargs={}),
        "noise_off": dict(
            cfg_kwargs=dict(noise_seq=zero_noise)
        ),
        "scen_none": dict(cfg_kwargs=dict(scenario_mode="none")),
        "both_off": dict(
            cfg_kwargs=dict(noise_seq=zero_noise, scenario_mode="none")
        ),
        "fixedhz": dict(cfg_kwargs={}, fixed=True),
    }
    out = {"device": device_record()}
    for name, kw in variants.items():
        out[name] = round(measure(kw.get("cfg_kwargs", {}),
                                  fixed=kw.get("fixed", False)))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
