"""Pallas fast-path rollout: exact parity (deterministic config) vs the XLA
env path, and law-level statistics for the stochastic config.  Runs in
pallas interpret mode on CPU (the compiled kernel runs on a GPU,
tests/test_gpu.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simglucose_tpu.controllers.functional import (
    bb_params,
    bb_policy,
    pid_controller,
)
from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.envs.rollout import (
    batch_reset,
    broadcast_ctrl_state,
    make_batch_continue_fn,
)
from simglucose_tpu.models.uva_padova import basal_rate
from simglucose_tpu.ops.pallas_rollout import (
    PallasRolloutConfig,
    config_for_sensor,
    make_pallas_rollout,
    make_sharded_pallas_rollout,
    pack_params,
)
from simglucose_tpu.params import load_quest_params

B = 128  # one lane row per block for the interpret-mode tests


def _packed(names, quest=None):
    cfg_env, params = make_env(names, batch=True, dtype=np.float32)
    return params, pack_params(
        params.patient, basal_rate(params.patient), quest=quest
    )


def test_deterministic_matches_env_exactly():
    """No noise / no meals / no resets: the kernel must reproduce the XLA
    env trace (same rk4 physics, PID controller, pump quantization)."""
    names = cohort_names(B)
    env_params, packed = _packed(names)

    T = 6
    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=True,
        controller="pid",
    )
    run = make_pallas_rollout(pcfg, B, interpret=True)
    traj_p = run(packed, 0)

    # XLA path: same config — zero noise (exogenous zeros), no meals,
    # no auto-reset, x0 init, PID on prev obs
    cfg, params = make_env(
        names,
        batch=True,
        dtype=np.float32,
        scenario_mode="none",
        noise_seq=np.zeros(T + 4, np.float32),
        substeps=1,
        method="rk4",
    )
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys, start_min=0)
    cs = broadcast_ctrl_state(ctrl0, B)
    run_env = make_batch_continue_fn(cfg, ctrl, T)
    _, _, _, traj_e = run_env(params, state, cs, res)

    np.testing.assert_allclose(
        np.asarray(traj_p["BG"]), np.asarray(traj_e.BG), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["CGM"]), np.asarray(traj_e.CGM), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["insulin"]), np.asarray(traj_e.insulin), rtol=1e-6
    )
    # reward is a difference of two ~3.0 risks through log/pow — a few f32
    # ulps of absolute noise (measured 1.6e-5 max)
    np.testing.assert_allclose(
        np.asarray(traj_p["reward"]),
        np.asarray(traj_e.reward),
        atol=1e-4,
    )
    np.testing.assert_array_equal(
        np.asarray(traj_p["CHO"]), np.asarray(traj_e.CHO)
    )
    np.testing.assert_array_equal(
        np.asarray(traj_p["done"]), np.asarray(traj_e.done)
    )


def test_deterministic_bb_with_meals_matches_env_exactly():
    """Static meal schedule + basal-bolus therapy: exercises the eating
    state machine (EAT_RATE spreading, Dbar gastric branch) and the BB bolus
    path (meal announcement from the previous step's CHO, Quest CR/CF,
    G>150 correction) under exact kernel-vs-env parity."""
    names = cohort_names(B)
    quest = load_quest_params(names, dtype=np.float32)
    env_params, packed = _packed(names, quest=quest)

    T = 12
    meal_times = (3, 10)  # absolute episode minutes
    meal_amounts = (30.0, 25.0)  # grams (30 g -> 6 min of EAT_RATE eating)
    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=True,
        controller="bb",
        det_meal_times=meal_times, det_meal_amounts=meal_amounts,
    )
    run = make_pallas_rollout(pcfg, B, interpret=True)
    traj_p = run(packed, 0)

    meal_seq = np.zeros(T * 3 + 1, np.float32)
    for t, a in zip(meal_times, meal_amounts):
        meal_seq[t] = a
    cfg, params = make_env(
        names,
        batch=True,
        dtype=np.float32,
        scenario_mode="exogenous",
        meal_seq=meal_seq,
        noise_seq=np.zeros(T + 4, np.float32),
        substeps=1,
        method="rk4",
    )
    ctrl = bb_policy(cfg.sample_time)
    cs = bb_params(params.patient, quest)  # [B] BBParams as vmapped state
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys, start_min=0)
    run_env = make_batch_continue_fn(cfg, ctrl, T)
    _, _, _, traj_e = run_env(params, state, cs, res)

    assert np.asarray(traj_p["CHO"]).max() > 0, "meals must fire"
    assert np.asarray(traj_p["insulin"]).max() > np.asarray(
        traj_p["insulin"]
    ).min(), "bolus must fire"
    np.testing.assert_array_equal(
        np.asarray(traj_p["CHO"]), np.asarray(traj_e.CHO)
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["insulin"]), np.asarray(traj_e.insulin), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["BG"]), np.asarray(traj_e.BG), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["CGM"]), np.asarray(traj_e.CGM), rtol=2e-6
    )


@pytest.mark.parametrize(
    "sensor", ["Navigator", "GuardianRT"]  # sample_time 1 and 5
)
def test_deterministic_other_sensors_match_env(sensor):
    """The kernel's sample_time is a static config knob — GuardianRT (5 min)
    and Navigator (1 min) change the unrolled minute loop and the
    reward/step cadence; both must still match the env path exactly."""
    names = cohort_names(B)
    env_params, packed = _packed(names)

    T = 4
    pcfg = config_for_sensor(
        sensor, n_steps=T, deterministic=True,
        controller="pid",
    )
    run = make_pallas_rollout(pcfg, B, interpret=True)
    traj_p = run(packed, 0)

    cfg, params = make_env(
        names,
        sensor=sensor,
        batch=True,
        dtype=np.float32,
        scenario_mode="none",
        noise_seq=np.zeros(T + 4, np.float32),
        substeps=1,
        method="rk4",
    )
    assert cfg.sample_time == pcfg.sample_time
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys, start_min=0)
    cs = broadcast_ctrl_state(ctrl0, B)
    run_env = make_batch_continue_fn(cfg, ctrl, T)
    _, _, _, traj_e = run_env(params, state, cs, res)

    np.testing.assert_allclose(
        np.asarray(traj_p["BG"]), np.asarray(traj_e.BG), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["insulin"]), np.asarray(traj_e.insulin), rtol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(traj_p["done"]), np.asarray(traj_e.done)
    )


def test_sharded_kernel_matches_unsharded():
    """The multi-chip fast path (shard_map over a dp mesh, one kernel per
    device) must reproduce the single-device kernel exactly in the
    deterministic config — patients are embarrassingly parallel, so sharding
    cannot change any value."""
    from simglucose_tpu.parallel.sharding import make_mesh, batch_sharding

    B8 = 8 * 128  # one lane row per device on the 8-device CPU mesh
    names = cohort_names(B8)
    _, packed = _packed(names)

    T = 4
    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=True,
        controller="pid",
    )
    ref = make_pallas_rollout(pcfg, B8, interpret=True)(packed, 0)

    mesh = make_mesh(dp=8, tp=1)
    packed_s = jax.device_put(
        packed,
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "dp")),
    )
    run = make_sharded_pallas_rollout(pcfg, B8, mesh, interpret=True)
    got = run(packed_s, 0)

    # interpret mode re-lowers the kernel body per shard, so XLA may fuse in
    # a different order — bitwise on real hardware, f32-ulp here
    for k in ("BG", "CGM", "insulin", "CHO", "BG0", "CGM0"):
        np.testing.assert_allclose(
            np.asarray(got[k]), np.asarray(ref[k]), rtol=1e-6, err_msg=k
        )
    # outputs carry the dp sharding (per-host IO can pull local shards)
    assert len(got["BG"].sharding.device_set) == 8


def test_sharded_exogenous_noise_matches_unsharded():
    """The unified sharded wrapper must carry EVERY kernel configuration —
    here the exogenous-noise + static-meal + persistent-free BB config: the
    caller-supplied noise planes are consumed batch-sharded and the result
    matches the single-device kernel exactly (patients are embarrassingly
    parallel; reference analog sim_engine.py:65-76)."""
    from simglucose_tpu.compat.noise import reference_cgm_noise
    from simglucose_tpu.params import sensor_record
    from simglucose_tpu.parallel.sharding import make_mesh

    B8 = 8 * 128
    names = cohort_names(B8)
    quest = load_quest_params(names, dtype=np.float32)
    _, packed = _packed(names, quest=quest)

    T = 4
    noise = reference_cgm_noise(sensor_record("Dexcom"), 1, T + 2).astype(
        np.float32
    )
    rng = np.random.RandomState(7)
    # per-lane noise planes (not broadcast): sharding must split them
    reset_noise = rng.standard_normal((2, B8)).astype(np.float32)
    step_noise = np.broadcast_to(noise[2:, None], (T, B8)).astype(
        np.float32
    ) + rng.standard_normal((T, B8)).astype(np.float32)

    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=True,
        exogenous_noise=True, autoreset=False, controller="bb",
        det_meal_times=(3,), det_meal_amounts=(30.0,),
    )
    ref = make_pallas_rollout(pcfg, B8, interpret=True)(
        packed, 0, reset_noise, step_noise
    )

    mesh = make_mesh(dp=8, tp=1)
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, "dp")
    )
    run = make_sharded_pallas_rollout(pcfg, B8, mesh, interpret=True)
    got = run(
        jax.device_put(packed, spec),
        0,
        reset_noise=jax.device_put(jnp.asarray(reset_noise), spec),
        step_noise=jax.device_put(jnp.asarray(step_noise), spec),
    )
    for k in ("BG", "CGM", "insulin", "CHO", "BG0", "CGM0"):
        np.testing.assert_allclose(
            np.asarray(got[k]), np.asarray(ref[k]), rtol=1e-6, err_msg=k
        )
    assert len(got["CGM"].sharding.device_set) == 8


def test_sharded_wrapper_rejects_missing_inputs():
    """Unsupported/incomplete sharded configs fail with a clear ValueError
    at call time, not an opaque trace-time error."""
    from simglucose_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(dp=8, tp=1)
    B8 = 8 * 128
    names = cohort_names(B8)
    _, packed = _packed(names)

    pcfg = PallasRolloutConfig(
        n_steps=4, deterministic=True,
        exogenous_noise=True, autoreset=False,
    )
    run = make_sharded_pallas_rollout(pcfg, B8, mesh, interpret=True)
    with pytest.raises(ValueError, match="exogenous_noise config needs"):
        run(packed, 0)

    ncfg = PallasRolloutConfig(
        n_steps=4, deterministic=True,
        controller="nn", nn_hidden=16,
    )
    nrun = make_sharded_pallas_rollout(ncfg, B8, mesh, interpret=True)
    with pytest.raises(ValueError, match="'nn' config needs weights"):
        nrun(packed, 0)

    with pytest.raises(ValueError, match="must divide"):
        make_sharded_pallas_rollout(pcfg, 8 * 128 + 4, mesh, interpret=True)


def test_exogenous_noise_matches_env_exactly():
    """NONZERO noise, exact parity: the kernel consumes the same
    MT19937-bit-exact reference noise stream the env path does
    (reference: sensor/noise_gen.py:15-69 via compat) plus a static meal
    schedule — every output must match the env path, golden-verifying the
    kernel's sensor data path the same way the env path is verified."""
    from simglucose_tpu.compat.noise import reference_cgm_noise
    from simglucose_tpu.params import sensor_record

    names = cohort_names(B)
    quest = load_quest_params(names, dtype=np.float32)
    env_params, packed = _packed(names, quest=quest)

    T = 8
    meal_times = (3, 10)
    meal_amounts = (30.0, 25.0)
    noise = reference_cgm_noise(sensor_record("Dexcom"), 1, T + 2).astype(
        np.float32
    )
    bc = lambda a: np.broadcast_to(a[:, None], (len(a), B))

    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=True,
        exogenous_noise=True, autoreset=False, controller="bb",
        det_meal_times=meal_times, det_meal_amounts=meal_amounts,
    )
    run = make_pallas_rollout(pcfg, B, interpret=True)
    traj_p = run(packed, 0, bc(noise[:2]), bc(noise[2:]))

    meal_seq = np.zeros(T * 3 + 1, np.float32)
    for t, a in zip(meal_times, meal_amounts):
        meal_seq[t] = a
    cfg, params = make_env(
        names,
        batch=True,
        dtype=np.float32,
        scenario_mode="exogenous",
        meal_seq=meal_seq,
        noise_seq=noise,
        substeps=1,
        method="rk4",
    )
    ctrl = bb_policy(cfg.sample_time)
    cs = bb_params(params.patient, quest)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys, start_min=0)
    run_env = make_batch_continue_fn(cfg, ctrl, T)
    _, _, _, traj_e = run_env(params, state, cs, res)

    # the noise is nonzero and identical on both paths
    assert abs(noise[0]) > 1.0
    np.testing.assert_allclose(
        np.asarray(traj_p["CGM0"]), np.asarray(res.CGM), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["CGM"]), np.asarray(traj_e.CGM), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["BG"]), np.asarray(traj_e.BG), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["insulin"]), np.asarray(traj_e.insulin), rtol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(traj_p["CHO"]), np.asarray(traj_e.CHO)
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["reward"]), np.asarray(traj_e.reward), atol=1e-4
    )


def test_static_scenario_stochastic_path_matches_env_exactly():
    """scenario_kind='static' (the custom-scenario fast path): the
    STOCHASTIC kernel code path with a static meal schedule and exogenous
    reference noise must match the env path exactly — meals AND noise on.
    This is the parity contract behind simulate(scenario=[(h, g), ...])
    staying on the kernel (reference CustomScenario, scenario.py:21-45)."""
    from simglucose_tpu.compat.noise import reference_cgm_noise
    from simglucose_tpu.params import sensor_record

    names = cohort_names(B)
    quest = load_quest_params(names, dtype=np.float32)
    env_params, packed = _packed(names, quest=quest)

    T = 8
    meal_times = (3, 10)
    meal_amounts = (30.0, 25.0)
    noise = reference_cgm_noise(sensor_record("Dexcom"), 1, T + 2).astype(
        np.float32
    )
    bc = lambda a: np.broadcast_to(a[:, None], (len(a), B))

    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=False, scenario_kind="static", exogenous_noise=True, autoreset=False, random_init_bg=False,
        fixed_start_min=0, controller="bb",
        det_meal_times=meal_times, det_meal_amounts=meal_amounts,
    )
    run = make_pallas_rollout(pcfg, B, interpret=True)
    traj_p = run(packed, 0, bc(noise[:2]), bc(noise[2:]))

    meal_seq = np.zeros(T * 3 + 1, np.float32)
    for t, a in zip(meal_times, meal_amounts):
        meal_seq[t] = a
    cfg, params = make_env(
        names,
        batch=True,
        dtype=np.float32,
        scenario_mode="exogenous",
        meal_seq=meal_seq,
        noise_seq=noise,
        substeps=1,
        method="rk4",
    )
    ctrl = bb_policy(cfg.sample_time)
    cs = bb_params(params.patient, quest)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys, start_min=0)
    run_env = make_batch_continue_fn(cfg, ctrl, T)
    _, _, _, traj_e = run_env(params, state, cs, res)

    np.testing.assert_array_equal(
        np.asarray(traj_p["CHO"]), np.asarray(traj_e.CHO)
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["CGM"]), np.asarray(traj_e.CGM), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["BG"]), np.asarray(traj_e.BG), rtol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(traj_p["insulin"]), np.asarray(traj_e.insulin), rtol=1e-6
    )


def test_static_scenario_native_noise_law():
    """scenario_kind='static' with NATIVE noise ('sw' PRNG, random init BG,
    autoreset off): meals are exact (static schedule), while the CGM-BG
    residual follows the Johnson-SU law — the configuration simulate() runs
    custom scenarios in."""
    names = cohort_names(B)
    _, packed = _packed(names)
    T = 6
    pcfg = PallasRolloutConfig(
        n_steps=T, deterministic=False, scenario_kind="static", autoreset=False, random_init_bg=True, fixed_start_min=0,
        controller="pid",
        det_meal_times=(3, 12), det_meal_amounts=(30.0, 25.0),
    )
    traj = make_pallas_rollout(pcfg, B, interpret=True)(packed, 5)
    cho = np.asarray(traj["CHO"])
    expect = np.zeros((T,), np.float32)
    expect[1] = 10.0  # 30 g announced over the 3-min step containing min 3
    expect[4] = 25.0 / 3.0  # min 12 -> step 4
    np.testing.assert_allclose(cho, expect[:, None] * np.ones((1, B)),
                               rtol=1e-6)
    resid = np.asarray(traj["CGM"]) - np.asarray(traj["BG"])
    # Johnson-SU noise is nonzero and bounded sane (std ~11.5 at Dexcom law)
    assert 2.0 < resid.std() < 40.0
    assert np.isfinite(np.asarray(traj["BG"])).all()


def test_stochastic_law():
    """Stochastic config: BG stays physiological, meals arrive at the daily
    law's rate, CGM noise has the Johnson-SU scale (interpret mode here;
    the compiled kernel runs the same checks at B=4096 in
    tests/test_gpu.py)."""
    names = cohort_names(B)
    _, packed = _packed(names)
    T = 16
    pcfg = PallasRolloutConfig(n_steps=T)
    run = make_pallas_rollout(pcfg, B, interpret=True)
    traj = run(packed, 7)

    bg = np.asarray(traj["BG"])
    assert np.isfinite(bg).all()
    assert 60 < bg.mean() < 250
    # meals arrive at the slot law's rate: ~3.9 meals/day/patient averaging
    # ~220 g/day; over the T-step window (random start hours spread lanes
    # across the day) the per-lane-hour CHO rate lands in a broad band
    cho_rate_per_day = (
        np.asarray(traj["CHO"]).mean() * pcfg.sample_time * 480
    )
    assert 40 < cho_rate_per_day < 500
    # noise scale: CGM - BG has std in the Johnson-SU ballpark (a few mg/dL)
    resid = np.asarray(traj["CGM"]) - bg
    assert 1.0 < resid.std() < 40.0
    # same seed bit-reproducible; different seed differs
    traj_same = run(packed, 7)
    np.testing.assert_array_equal(bg, np.asarray(traj_same["BG"]))
    traj_diff = run(packed, 8)
    assert not np.array_equal(bg, np.asarray(traj_diff["BG"]))
    # init BG randomization is active (random_init_bg=True default)
    assert len(np.unique(np.asarray(traj["BG0"]))) > B // 2


def test_chunked_persistent_matches_single_call_exactly():
    """Long-horizon chunking contract (sim/engine.py _simulate_pallas): a
    horizon run as K persistent_state chunks, chunk c passing
    ``step0 = c * n_steps``, is BIT-identical to the single-call run —
    every random draw is a function of (seed, lane, global step, site), so
    the second call continues the streams exactly where the first stopped.
    Stochastic config (noise + random meals + random init BG + random
    start hours) so every draw site is exercised; the 3-step chunks start
    the second call on an odd step, where the noise pair is redrawn."""
    names = cohort_names(B)
    _, packed = _packed(names)
    common = dict(controller="pid", autoreset=False, random_init_bg=True,
                  regen_every=2)
    single = PallasRolloutConfig(n_steps=6, **common)
    chunked = PallasRolloutConfig(n_steps=3, persistent_state=True, **common)

    traj_s = make_pallas_rollout(single, B, interpret=True)(packed, 13)

    run_c = make_pallas_rollout(chunked, B, interpret=True)
    out0 = run_c(packed, 13, init=1)
    out1 = run_c(
        packed, 13, state=(out0["state_f"], out0["state_i"]), init=0,
        step0=chunked.n_steps,
    )
    for k in ("BG", "CGM", "CHO", "insulin", "reward", "done"):
        got = np.concatenate(
            [np.asarray(out0[k]), np.asarray(out1[k])], axis=0
        )
        np.testing.assert_array_equal(
            got, np.asarray(traj_s[k]), err_msg=k
        )
    # the reset rows come from the init call
    np.testing.assert_array_equal(
        np.asarray(out0["BG0"]), np.asarray(traj_s["BG0"])
    )
    np.testing.assert_array_equal(
        np.asarray(out0["CGM0"]), np.asarray(traj_s["CGM0"])
    )


def test_bb_without_quest_fails_loudly():
    """Quest-reading configs (controller='bb', nn_decoder='residual_bb')
    must FAIL LOUDLY when pack_params was called without quest=: the
    CR/CF planes carry a finite -1.0 sentinel (NaN-free so multi-process
    device_put equality checks pass) that the kernel converts to NaN, so
    the first meal bolus poisons the trajectory instead of silently
    dosing with CR=CF=1 (meal-gram-sized insulin rates)."""
    names = cohort_names(B)
    _, packed = _packed(names)  # NO quest -> -1.0 sentinel planes
    assert np.isfinite(np.asarray(packed)).all(), (
        "packed params must stay NaN-free for multi-process device_put"
    )
    pcfg = PallasRolloutConfig(
        n_steps=2, deterministic=True,
        controller="bb",
        det_meal_times=(0,), det_meal_amounts=(30.0,),
    )
    traj = make_pallas_rollout(pcfg, B, interpret=True)(packed, 0)
    ins = np.asarray(traj["insulin"])
    # the meal is announced during step 0 -> step 1's bolus reads the NaN
    # CR plane and the failure is visible in the outputs
    assert np.isnan(ins[1]).all()
