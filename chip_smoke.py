#!/usr/bin/env python
"""Smoke test of the simulator and PPO trainer on a GPU, end to end.

Runs the main path once, through the entry points a user calls, in ONE
process (a JAX process reserves most of a card's memory, so a second one
would fail), and checks every result:

  phase 1  golden parity: the 2-day closed-loop reference trace
           (adolescent#001, float64, rk45, 4 substeps, 960 steps) through
           the XLA env path, against tests/golden/closedloop_golden.npz;
  phase 2  the reference's canonical cohort (30 patients x 24 h, basal-
           bolus, Dexcom, random scenario) through simulate_arrays on the
           rollout kernel and on the XLA engine, law-gated, with time in
           range and risk index;
  phase 3  the rollout kernel at B=4096: deterministic config against
           env_step, stochastic PID / GuardianRT / Navigator law gates, and
           (for information) env-steps/s, compile time and memory of the
           kernel and of the XLA rollout at B in {4096, 65536, 262144};
  phase 4  training: the XLA trainer and the fused trainer at B=8192,
           T=64, 2 epochs x 4 minibatches, H=64, plus one residual_bb
           iteration — metrics finite, parameters moved;
  phase 5  the shipped residual_bb checkpoint on 30 patients x 24 h through
           evaluate_policy_kernel and through the XLA evaluate_controller,
           compared law to law.

``--four-cards`` runs only the multi-device path on four cards (sharded
kernel vs single device, dp=4 vs dp=1 XLA training, fused training over
the mesh).  No phase catches its own failure; the script exits non-zero,
printing no result line, when JAX finds no GPU.  The last line of output
is ``{"ok": true, "device": {...}}``.

Usage:  python chip_smoke.py [--four-cards] [--out FILE.json]
"""
import argparse
import json
import os
import sys
import time
from datetime import datetime, timedelta

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Sizes: the phases' real widths (module constants, so a CPU rehearsal can
# shrink them).
DAY = 480  # Dexcom steps in 24 h
WIDE = 4096  # kernel parity and law-gate batch
RATE_BATCHES = (4096, 65536, 262144)  # env-steps/s comparison batches
SENSOR_B, SENSOR_T = 1024, 576  # GuardianRT / Navigator law gates
TRAIN_B, TRAIN_T, HIDDEN = 8192, 64, 64  # BASELINE config 4
FOUR_B = 16384  # --four-cards kernel batch
# kernel vs env_step over a day, deterministic config, max relative error:
# both paths run the same f32 arithmetic.  Measured on the H100: BG and CGM
# equal bit for bit, insulin within one f32 ulp (1.03e-7) at B=4096.
DET_TOL = 1e-6


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _timed(fn, *args, reps=3):
    """(seconds per call, last output): one warm call, then ``reps``
    timed calls ending in block_until_ready."""
    import jax

    out = jax.block_until_ready(fn(*args))
    tic = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - tic) / reps, out


# ---------------------------------------------------------------------------
# phase 1: golden parity
# ---------------------------------------------------------------------------


def phase_golden(res):
    import jax

    from simglucose_tpu.compat.noise import reference_cgm_noise
    from simglucose_tpu.compat.scenario import reference_meal_seq
    from simglucose_tpu.controllers.functional import bb_controller, bb_params
    from simglucose_tpu.envs.build import make_env
    from simglucose_tpu.envs.rollout import rollout
    from simglucose_tpu.params import load_quest_params, sensor_record

    n = 2 * 24 * 60 // 3
    with jax.enable_x64(True):
        noise = reference_cgm_noise(sensor_record("Dexcom"), 1, n + 2)
        meals = reference_meal_seq(1, datetime(2018, 1, 1), n * 3 + 1)
        cfg, params = make_env(
            "adolescent#001", dtype=np.float64, noise_seq=noise,
            meal_seq=meals, substeps=4, method="rk45",
        )
        quest = jax.tree.map(
            lambda a: a[0],
            load_quest_params("adolescent#001", dtype=np.float64),
        )
        ctrl0, ctrl = bb_controller(bb_params(params.patient, quest),
                                    cfg.sample_time)
        _, reset_res, traj = jax.jit(
            lambda k: rollout(cfg, params, k, ctrl0, ctrl, n)
        )(jax.random.PRNGKey(0))
        bg = np.concatenate([[float(reset_res.BG)], np.asarray(traj.BG)])
        cho = np.asarray(traj.CHO)
        ins = np.asarray(traj.insulin)
        assert bg.dtype == np.float64
    g = np.load(os.path.join(ROOT, "tests", "golden", "closedloop_golden.npz"))
    err = {
        "BG": _max_rel(bg, g["BG"]),
        "CHO": _max_rel(cho, g["CHO"][:-1]),
        "insulin": _max_rel(ins, g["insulin"][:-1]),
    }
    _log("phase 1", f"golden 960-step trace, max relative error: {err}")
    res["golden_max_rel_err"] = err
    assert err["BG"] <= 5e-8, err
    assert err["CHO"] <= 1e-12 and err["insulin"] <= 1e-12, err


# ---------------------------------------------------------------------------
# phase 2: the canonical cohort on both engines
# ---------------------------------------------------------------------------


def phase_cohort(res):
    from simglucose_tpu import params as tables
    from simglucose_tpu.analysis.laws import (
        BB_COHORT_BANDS,
        check_bands,
        law_stats,
    )
    from simglucose_tpu.rl.evaluate import cohort_stats
    from simglucose_tpu.sim.engine import simulate_arrays

    names = tables.patient_names()
    assert len(names) == 30
    for engine in ("pallas", "xla"):
        tic = time.perf_counter()
        arr = simulate_arrays(
            sim_time=timedelta(days=1), patient_names=names,
            controller="BB", cgm_name="Dexcom", scenario_seed=7,
            cgm_seed=11, engine=engine,
        )
        wall = time.perf_counter() - tic
        assert arr.engine == engine
        bg = arr.traj.BG
        assert bg.shape == (DAY, 30) and np.isfinite(bg).all()
        stats = law_stats(
            {"BG": bg, "CGM": arr.traj.CGM, "CHO": arr.traj.CHO,
             "done": (bg < 70.0) | (bg > 350.0)},
            arr.sample_time,
        )
        cs = cohort_stats(bg.T)
        stats["TIR_70_180"] = float(cs["percent_in_70_180"].mean())
        stats["risk_index"] = float(cs["risk_index"].mean())
        stats["first_call_s"] = wall
        _log("phase 2", f"cohort 30x24h BB on {engine}: {stats}")
        check_bands(stats, BB_COHORT_BANDS, f"cohort/{engine}")
        res[f"cohort_{engine}"] = stats


# ---------------------------------------------------------------------------
# phase 3: the rollout kernel at scale
# ---------------------------------------------------------------------------


def _packed(B, quest=False):
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import pack_params
    from simglucose_tpu.params import load_quest_params

    names = cohort_names(B)
    _, params = make_env(names, batch=True, dtype=np.float32)
    q = load_quest_params(names, dtype=np.float32) if quest else None
    return pack_params(params.patient, basal_rate(params.patient), quest=q)


def deterministic_parity(B, T):
    """Max relative errors of the deterministic PID kernel config against
    the XLA env path (no noise, meals or resets)."""
    import jax

    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_continue_fn,
    )
    from simglucose_tpu.ops.pallas_rollout import (
        PallasRolloutConfig,
        make_pallas_rollout,
    )

    pcfg = PallasRolloutConfig(n_steps=T, deterministic=True, controller="pid")
    traj_p = jax.jit(make_pallas_rollout(pcfg, B))(_packed(B), 0)
    cfg, params = make_env(
        cohort_names(B), batch=True, dtype=np.float32, scenario_mode="none",
        noise_seq=np.zeros(T + 4, np.float32), substeps=1, method="rk4",
    )
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, rst = batch_reset(cfg, params, keys, start_min=0)
    _, _, _, traj_e = make_batch_continue_fn(cfg, ctrl, T)(
        params, state, broadcast_ctrl_state(ctrl0, B), rst
    )
    err = {k: _max_rel(traj_p[k], getattr(traj_e, k))
           for k in ("BG", "CGM", "insulin")}
    err["CHO_equal"] = bool(np.array_equal(traj_p["CHO"], traj_e.CHO))
    err["done_equal"] = bool(np.array_equal(traj_p["done"], traj_e.done))
    return err


def phase_rollout(res):
    import jax

    from simglucose_tpu.analysis.laws import (
        PID_BANDS,
        SENSOR_BANDS,
        check_bands,
        law_stats,
    )
    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_rollout_fn,
    )
    from simglucose_tpu.ops.pallas_rollout import (
        config_for_sensor,
        make_pallas_rollout,
    )

    # (a) deterministic config against env_step at real width, a full day
    err = deterministic_parity(WIDE, DAY)
    _log("phase 3", f"deterministic kernel vs env_step, B={WIDE} T={DAY}: "
                    f"max rel err {err}")
    res["det_parity"] = err
    assert err["CHO_equal"] and err["done_equal"], err
    assert max(err["BG"], err["CGM"], err["insulin"]) <= DET_TOL, err

    # (b) stochastic PID (Dexcom, auto-reset) and the other sensors' sample
    # times, law-gated
    gates = [("Dexcom", WIDE, DAY, PID_BANDS)] + [
        (s, SENSOR_B, SENSOR_T, b) for s, b in SENSOR_BANDS.items()
    ]
    for sensor, B, T, bands in gates:
        cfg = config_for_sensor(sensor, controller="pid", n_steps=T)
        traj = jax.jit(make_pallas_rollout(cfg, B))(_packed(B), 11)
        stats = law_stats(traj, cfg.sample_time)
        _log("phase 3", f"stochastic PID {sensor} B={B} T={T}: {stats}")
        check_bands(stats, bands, f"kernel/{sensor}")
        res[f"law_{sensor}"] = stats

    # (c) information: kernel vs the XLA rollout, same config (PID,
    # auto-reset, Dexcom, random scenario), T = 1 day
    T = DAY
    cfg = config_for_sensor("Dexcom", controller="pid", n_steps=T)
    for B in RATE_BATCHES:
        packed = _packed(B)
        tic = time.perf_counter()
        compiled = jax.jit(make_pallas_rollout(cfg, B)).lower(packed, 0).compile()
        t_compile = time.perf_counter() - tic
        mem = compiled.memory_analysis()
        sec, traj = _timed(compiled, packed, 1)
        stats = law_stats(traj, cfg.sample_time)
        check_bands(stats, PID_BANDS, f"kernel B={B}")
        k_rate = B * T / sec

        ecfg, params = make_env(cohort_names(B), batch=True,
                                random_init_bg=True, dtype=np.float32)
        ctrl0, ctrl = pid_controller(ecfg.sample_time, P=-1e-4, I=-1e-7)
        state, rst = jax.jit(lambda p, k: batch_reset(ecfg, p, k))(
            params, jax.random.split(jax.random.PRNGKey(0), B)
        )
        run = make_batch_rollout_fn(ecfg, ctrl, n_steps=T, donate=False,
                                    reset_cadence=8)
        cs = broadcast_ctrl_state(ctrl0, B)
        tic = time.perf_counter()
        jax.block_until_ready(run(params, state, cs, rst))
        t_first_xla = time.perf_counter() - tic
        sec_x, (_, _, traj_x) = _timed(run, params, state, cs, rst)
        x_rate = B * T / sec_x
        row = {
            "kernel_steps_per_s": k_rate, "xla_steps_per_s": x_rate,
            "speedup": k_rate / x_rate, "kernel_compile_s": t_compile,
            "xla_first_call_s": t_first_xla,
            "kernel_temp_bytes": int(mem.temp_size_in_bytes),
            "kernel_output_bytes": int(mem.output_size_in_bytes),
            "kernel_bg_mean": stats["bg_mean"],
            "xla_bg_mean": float(np.asarray(traj_x.BG).mean()),
        }
        _log("phase 3", f"rollout B={B} T={T}: {row}")
        res[f"rollout_B{B}"] = row


# ---------------------------------------------------------------------------
# phase 4: training
# ---------------------------------------------------------------------------


def _moved(a, b):
    import jax

    return any(
        not np.allclose(np.asarray(x), np.asarray(y))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b))
    )


def _finite(metrics):
    return all(np.isfinite(np.asarray(v)).all() for v in metrics.values())


def xla_train_setup(B, ppo_cfg, mesh=None):
    import jax

    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import batch_reset
    from simglucose_tpu.parallel.sharding import replicate, shard_batch
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import TrainState, make_optimizer

    cfg, env_params = make_env(cohort_names(B), batch=True,
                               random_init_bg=True, dtype=np.float32)
    key = jax.random.PRNGKey(0)
    env_state, reset_res = jax.jit(
        lambda p, k: batch_reset(cfg, p, k)
    )(env_params, jax.random.split(key, B))
    policy = init_policy(jax.random.fold_in(key, 1), hidden=HIDDEN,
                         act="relu", init_mu_bias=-2.2)
    # explicit observation-memory carries (the cold-start values), so the
    # state's structure — and the compiled step — is the same every call
    cgm0 = reset_res.observation.CGM
    ts = TrainState(params=policy,
                    opt_state=make_optimizer(ppo_cfg).init(policy),
                    env_state=env_state, prev_res=reset_res, key=key,
                    cgm_prev=cgm0, iob=jax.numpy.zeros_like(cgm0))
    if mesh is not None:
        env_params = shard_batch(env_params, mesh)
        ts = TrainState(
            params=replicate(ts.params, mesh),
            opt_state=replicate(ts.opt_state, mesh),
            env_state=shard_batch(ts.env_state, mesh),
            prev_res=shard_batch(ts.prev_res, mesh),
            key=replicate(ts.key, mesh),
            cgm_prev=shard_batch(ts.cgm_prev, mesh),
            iob=shard_batch(ts.iob, mesh),
        )
    return cfg, env_params, ts


def phase_training(res):
    import jax
    import jax.numpy as jnp

    from simglucose_tpu.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu.rl.policy import OBS_DIM, init_policy
    from simglucose_tpu.rl.ppo import (
        PPOConfig,
        Transition,
        _update,
        make_optimizer,
        make_train_step,
    )

    B, T, H = TRAIN_B, TRAIN_T, HIDDEN
    ppo_cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=4)

    # the XLA trainer (rl/ppo.make_train_step)
    cfg, env_params, ts = xla_train_setup(B, ppo_cfg)
    step = jax.jit(make_train_step(ppo_cfg, cfg))
    p0 = ts.params
    tic = time.perf_counter()
    ts, m = jax.block_until_ready(step(env_params, ts))
    t_first = time.perf_counter() - tic
    tic = time.perf_counter()
    for _ in range(3):
        ts, m = step(env_params, ts)
    jax.block_until_ready(ts)
    sec = (time.perf_counter() - tic) / 3
    assert _finite(m) and _moved(p0, ts.params)
    row = {"iter_s": sec, "first_call_s": t_first,
           **{k: float(v) for k, v in m.items()}}
    _log("phase 4", f"XLA trainer B={B} T={T}: {row}")
    res["train_xla"] = row

    # the learner alone (the PPO update both trainers share) on a
    # synthetic [T, B] rollout
    k = jax.random.split(jax.random.PRNGKey(3), 4)
    tr = Transition(
        obs=jax.random.normal(k[0], (T, B, OBS_DIM)),
        raw_action=jax.random.normal(k[1], (T, B)),
        logp=jnp.full((T, B), -1.0), value=jnp.zeros((T, B)),
        reward=jax.random.normal(k[2], (T, B)), done=jnp.zeros((T, B), bool),
    )
    advs = jax.random.normal(k[3], (T, B))
    opt = make_optimizer(ppo_cfg)
    upd = jax.jit(lambda p, o, key: _update(
        ppo_cfg, opt, p, o, tr, advs, advs, key, None))
    sec, _ = _timed(upd, p0, opt.init(p0), jax.random.PRNGKey(4), reps=5)
    _log("phase 4", f"XLA learner alone (2 epochs x 4 minibatches of "
                    f"{T * B // 4} rows): {sec * 1e3:.3f} ms/iteration")
    res["learner_ms"] = sec * 1e3

    # the fused trainer (kernel actor + XLA learner), sigmoid decoder
    packed = _packed(B)
    policy = init_policy(jax.random.PRNGKey(1), hidden=H, act="relu",
                         init_mu_bias=-2.2)
    fts = init_fused_state(policy, make_optimizer(ppo_cfg).init(policy), B,
                           jax.random.PRNGKey(0))
    iters = 4
    loop = jax.jit(make_fused_train_loop(ppo_cfg, B, iters, hidden=H))
    tic = time.perf_counter()
    fts1, m = jax.block_until_ready(loop(packed, fts))
    t_first = time.perf_counter() - tic
    tic = time.perf_counter()
    fts2, m = jax.block_until_ready(loop(packed, fts1))
    sec = (time.perf_counter() - tic) / iters
    assert _finite(m) and _moved(policy, fts2.params)
    row = {"iter_s": sec, "first_call_s": t_first,
           **{k: float(np.asarray(v)[-1]) for k, v in m.items()}}
    _log("phase 4", f"fused trainer B={B} T={T}: {row}")
    res["train_fused"] = row

    # one residual_bb iteration (the policy modulates BB therapy; the
    # kernel reads the Quest CR/CF planes)
    rcfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=4,
                     decoder="residual_bb", action_scale=1.1)
    rpol = init_policy(jax.random.PRNGKey(2), hidden=H, act="relu",
                       decoder="residual_bb", action_scale=1.1)
    rts = init_fused_state(rpol, make_optimizer(rcfg).init(rpol), B,
                           jax.random.PRNGKey(0))
    rloop = jax.jit(make_fused_train_loop(rcfg, B, 1, hidden=H))
    rts1, m = jax.block_until_ready(rloop(_packed(B, quest=True), rts))
    assert _finite(m) and _moved(rpol, rts1.params)
    row = {k: float(np.asarray(v)[-1]) for k, v in m.items()}
    _log("phase 4", f"fused trainer residual_bb: {row}")
    res["train_fused_residual_bb"] = row


# ---------------------------------------------------------------------------
# phase 5: policy evaluation
# ---------------------------------------------------------------------------


def phase_eval(res):
    import jax

    from simglucose_tpu import params as tables
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.rl.evaluate import (
        evaluate_controller,
        evaluate_policy_kernel,
        policy_controller,
    )
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.utils.checkpoint import restore_state

    like = init_policy(jax.random.PRNGKey(0), hidden=HIDDEN, act="relu",
                       action_scale=1.1, decoder="residual_bb")
    policy = restore_state(
        os.path.join(ROOT, "examples", "checkpoints",
                     "ppo_cohort_residual_bb.npz"),
        like=like,
    )
    names = tables.patient_names()
    basal = basal_rate(tables.load_patient_params(names, dtype=np.float32))
    quest = tables.load_quest_params(names, dtype=np.float32)
    out = {}
    for name, r in (
        ("kernel", evaluate_policy_kernel(policy, names, hours=24.0,
                                          seed=1234)),
        ("xla", evaluate_controller(
            policy_controller(policy, basal, quest=quest), names,
            hours=24.0, seed=1234)),
    ):
        assert r["BG"].shape == (30, DAY) and np.isfinite(r["BG"]).all()
        out[name] = {
            "bg_mean": float(r["BG"].mean()),
            "TIR_70_180": float(r["percent_in_70_180"].mean()),
            "below_70": float(r["percent_below_70"].mean()),
            "risk_index": float(r["risk_index"].mean()),
        }
    _log("phase 5", f"residual_bb checkpoint, 30x24h: {out}")
    res["eval"] = out
    k, x = out["kernel"], out["xla"]
    # different random streams: agreement at the level of the laws (the
    # risk index is heavy-tailed over 30 patients, so it is reported only)
    assert abs(k["bg_mean"] - x["bg_mean"]) <= 15.0, out
    assert abs(k["TIR_70_180"] - x["TIR_70_180"]) <= 10.0, out
    assert abs(k["below_70"] - x["below_70"]) <= 5.0, out


# ---------------------------------------------------------------------------
# --four-cards: the multi-device path
# ---------------------------------------------------------------------------


def phase_four_cards(res):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from simglucose_tpu.ops.pallas_rollout import (
        config_for_sensor,
        make_pallas_rollout,
        make_sharded_pallas_rollout,
    )
    from simglucose_tpu.parallel.sharding import make_mesh
    from simglucose_tpu.rl.fused import init_fused_state, make_fused_train_loop
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer, make_train_step

    devs = jax.devices()[:4]
    mesh = make_mesh(dp=4, tp=1, devices=devs)
    ids = sorted(d.id for d in mesh.devices.flat)
    assert len(set(ids)) == 4, ids
    _log("four", f"mesh dp=4 over devices {ids}")
    lanes = NamedSharding(mesh, P(None, "dp"))

    def on_four(out):
        got = {s.device.id for s in out["BG"].addressable_shards}
        assert got == set(ids), got

    # (a) the sharded kernel against a single-device run of the same lanes:
    # exogenous-noise config (per-lane noise planes), and the stochastic
    # PID config (each device passes its first global lane, so the streams
    # match too)
    B, T = FOUR_B, DAY
    rng = np.random.RandomState(7)
    rnoise = rng.standard_normal((2, B)).astype(np.float32) * 5.0
    snoise = rng.standard_normal((T, B)).astype(np.float32) * 5.0
    exo = config_for_sensor(
        "Dexcom", n_steps=T, controller="bb", deterministic=True,
        exogenous_noise=True, autoreset=False,
        det_meal_times=(30, 400), det_meal_amounts=(45.0, 70.0),
    )
    sto = config_for_sensor("Dexcom", n_steps=T, controller="pid")
    for name, cfg, packed, kw in (
        ("exogenous-noise", exo, _packed(B, quest=True),
         dict(reset_noise=rnoise, step_noise=snoise)),
        ("stochastic PID", sto, _packed(B), {}),
    ):
        one = jax.jit(lambda p, **k: make_pallas_rollout(cfg, B)(p, 5, **k))(
            packed, **kw)
        sharded = make_sharded_pallas_rollout(cfg, B, mesh)
        four = jax.jit(lambda p, **k: sharded(p, 5, **k))(
            jax.device_put(packed, lanes),
            **{k: jax.device_put(jnp.asarray(v), lanes) for k, v in kw.items()},
        )
        on_four(four)
        err = {k: float(np.max(np.abs(np.asarray(four[k], np.float64)
                                      - np.asarray(one[k], np.float64))))
               for k in ("BG", "CGM", "insulin", "CHO", "BG0", "CGM0")}
        _log("four", f"sharded kernel vs one device ({name}, B={B}): "
                     f"max abs diff {err}")
        res[f"four_kernel_{name}"] = err
        assert max(err.values()) == 0.0, err

    # (b) the XLA trainer on dp=4 against dp=1
    Bt, Tt = TRAIN_B, TRAIN_T
    ppo_cfg = PPOConfig(rollout_steps=Tt, epochs=2, minibatches=4)
    cfg, env_params, ts = xla_train_setup(Bt, ppo_cfg)
    ts1, m1 = jax.jit(make_train_step(ppo_cfg, cfg))(env_params, ts)
    cfg, env_params4, ts4 = xla_train_setup(Bt, ppo_cfg, mesh=mesh)
    with mesh:
        ts4, m4 = jax.jit(make_train_step(ppo_cfg, cfg, mesh=mesh))(
            env_params4, ts4)
    diff = np.concatenate([
        np.abs(np.asarray(a) - np.asarray(b)).ravel()
        for a, b in zip(jax.tree.leaves(ts1.params),
                        jax.tree.leaves(ts4.params))
    ])
    lr = ppo_cfg.lr
    row = {"max_abs_param_diff": float(diff.max()),
           "frac_params_beyond_3lr": float((diff > 3 * lr).mean()),
           "reward_mean_dp1": float(m1["reward_mean"]),
           "reward_mean_dp4": float(m4["reward_mean"])}
    _log("four", f"make_train_step dp=4 vs dp=1 (B={Bt}): {row}")
    res["four_train_xla"] = row
    # the rollouts use the same keys and params, so their mean rewards agree
    # to f32 rounding.  Each Adam step moves a parameter by about lr; a
    # gradient component near zero, summed in another order on 4 devices,
    # can take the other sign, so a few parameters may end several lr
    # apart — but not many
    np.testing.assert_allclose(row["reward_mean_dp4"],
                               row["reward_mean_dp1"], rtol=1e-3)
    assert row["frac_params_beyond_3lr"] <= 0.01, row

    # (c) the fused trainer over the mesh
    Bf = 4 * TRAIN_B
    policy = init_policy(jax.random.PRNGKey(1), hidden=HIDDEN, act="relu",
                         init_mu_bias=-2.2)
    fts = init_fused_state(policy, make_optimizer(ppo_cfg).init(policy), Bf,
                           jax.random.PRNGKey(0), mesh=mesh)
    loop = jax.jit(make_fused_train_loop(ppo_cfg, Bf, 3, hidden=HIDDEN,
                                         mesh=mesh))
    packed = jax.device_put(_packed(Bf), lanes)
    with mesh:
        fts1, m = jax.block_until_ready(loop(packed, fts))
        tic = time.perf_counter()
        fts2, m = jax.block_until_ready(loop(packed, fts1))
        sec = (time.perf_counter() - tic) / 3
    assert _finite(m) and _moved(policy, fts2.params)
    got = {s.device.id for s in fts2.state_f.addressable_shards}
    assert got == set(ids), got
    row = {"iter_s": sec, **{k: float(np.asarray(v)[-1]) for k, v in m.items()}}
    _log("four", f"fused trainer over dp=4, B={Bf}: {row}")
    res["four_train_fused"] = row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path on four cards")
    ap.add_argument("--out", help="also write the measurements as JSON here")
    args = ap.parse_args(argv)

    import jax

    import simglucose_tpu
    from simglucose_tpu.utils.runtime import (
        device_record,
        gpu_name_and_power,
        use_compile_cache,
    )

    pkg = os.path.dirname(os.path.abspath(simglucose_tpu.__file__))
    if os.path.dirname(pkg) != ROOT:
        print(f"chip_smoke: simglucose_tpu imported from {pkg}, not from "
              f"this checkout ({ROOT})", file=sys.stderr)
        return 2
    dev = device_record()
    if dev["platform"] != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev['platform']!r})",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if dev["count"] < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {dev['count']}",
              file=sys.stderr)
        return 2
    cache = use_compile_cache()
    print(f"[device] {gpu_name_and_power()}", flush=True)
    print(f"[device] jax {jax.__version__}, {dev['count']} x {dev['kind']}, "
          f"compile cache {cache}", flush=True)

    res = {"device": dev, "gpu": gpu_name_and_power()}
    tic = time.perf_counter()
    phases = ([phase_four_cards] if args.four_cards else
              [phase_golden, phase_cohort, phase_rollout, phase_training,
               phase_eval])
    for phase in phases:
        t0 = time.perf_counter()
        phase(res)
        _log("time", f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    res["wall_s"] = time.perf_counter() - tic
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
