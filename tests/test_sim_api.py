"""High-level sim engine + interactive UI tests
(reference: tests/test_sim_engine.py, tests/test_ui.py)."""
from datetime import datetime, timedelta
from unittest import mock

import numpy as np
import pytest

from simglucose_tpu.sim.engine import SimObj, batch_sim, sim, simulate


def test_simulate_cohort_bb():
    df = simulate(
        sim_time=timedelta(hours=4),
        patient_names=["adolescent#001", "adult#001", "child#001"],
        controller="BB",
        scenario_seed=1,
        start_time=datetime(2018, 1, 1, 6, 0, 0),
    )
    assert df.index.nlevels == 2
    for name in ("adolescent#001", "adult#001", "child#001"):
        sub = df.loc[name]
        assert len(sub) == 4 * 60 // 3 + 1
        assert np.isfinite(sub.BG).all()
        assert (sub.BG > 10).all() and (sub.BG < 600).all()


def test_simulate_custom_scenario_pid():
    df = simulate(
        sim_time=timedelta(hours=2),
        patient_names=["adolescent#002"],
        controller="PID",
        scenario=[(0.5, 40.0)],  # 40 g at 30 min
        start_time=datetime(2018, 1, 1, 8, 0, 0),
    )
    sub = df.loc["adolescent#002"]
    assert sub.CHO.sum() > 0  # meal delivered
    # meal lands at the 30-minute mark
    cho_steps = np.flatnonzero(np.asarray(sub.CHO) > 0)
    assert cho_steps[0] == 30 // 3 + 1  # +1: row 0 is the reset sample


def test_simulate_pid_gains_configurable():
    """PID gains are per-run configurable through the controller spec, like
    the reference's PIDController(P, I, D) constructor
    (reference: controller/pid_ctrller.py:9-15)."""
    common = dict(
        sim_time=timedelta(hours=2),
        patient_names=["adult#001"],
        scenario=[(0.5, 40.0)],
        start_time=datetime(2018, 1, 1, 8, 0, 0),
    )
    df_default = simulate(controller="PID", **common)
    df_tuple = simulate(controller=("PID", dict(P=-1e-3, I=-1e-6)), **common)
    df_dict = simulate(controller={"PID": dict(P=-1e-3, I=-1e-6)}, **common)
    bg_default = np.asarray(df_default.loc["adult#001"].BG)
    bg_tuple = np.asarray(df_tuple.loc["adult#001"].BG)
    bg_dict = np.asarray(df_dict.loc["adult#001"].BG)
    # different gains change the trajectory; both spec forms are equivalent
    assert not np.array_equal(bg_default, bg_tuple)
    np.testing.assert_array_equal(bg_tuple, bg_dict)


def test_simulate_save_and_report(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    df = simulate(
        sim_time=timedelta(hours=2),
        patient_names=["adolescent#001", "adult#003"],
        controller="BB",
        save_path=str(tmp_path),
        start_time=datetime(2018, 1, 1),
    )
    assert (tmp_path / "adolescent#001.csv").exists()
    assert (tmp_path / "adult#003.csv").exists()
    assert (tmp_path / "performance_stats.csv").exists()
    import matplotlib.pyplot as plt

    plt.close("all")


def test_sim_obj_and_batch_fusion(tmp_path):
    objs = [
        SimObj(
            patient_name=n,
            controller="BB",
            sim_time=timedelta(hours=2),
            start_time=datetime(2018, 1, 1),
            seed=1,
            path=str(tmp_path),
        )
        for n in ("adolescent#001", "adolescent#002")
    ]
    results = batch_sim(objs, parallel=True)
    assert len(results) == 2
    for r, n in zip(results, ("adolescent#001", "adolescent#002")):
        assert len(r) == 2 * 60 // 3 + 1
        assert (tmp_path / f"{n}.csv").exists()


def test_batch_sim_matches_individual_sim():
    """Fused cohort program == per-patient programs
    (reference: tests/test_sim_engine.py:24-86 parallel==serial)."""
    mk = lambda n: SimObj(
        patient_name=n,
        controller="BB",
        sim_time=timedelta(hours=2),
        start_time=datetime(2018, 1, 1),
        seed=3,
    )
    names = ["adolescent#001", "child#002"]
    fused = batch_sim([mk(n) for n in names])
    singles = [sim(mk(n)) for n in names]
    for f, s in zip(fused, singles):
        np.testing.assert_allclose(
            np.asarray(f.BG), np.asarray(s.BG), rtol=1e-6
        )


def test_interactive_ui_wizard(monkeypatch):
    """Scripted stdin drives the full wizard in the REFERENCE's prompt
    order — animate, parallel, save path, sim time, scenario, patients
    (By-ID sub-loop with a duplicate rejection and 'D' to finish), CGM,
    seed, pump, controller (reference: user_interface.py:303-385,
    tests/test_ui.py:15-27)."""
    from simglucose_tpu.sim.user_interface import simulate as ui_simulate

    answers = iter(
        [
            "n",  # animate
            "y",  # parallel
            "",  # save path: skip
            "2",  # sim hours
            "1",  # Random Scenario
            "6",  # start hour
            "5",  # patients: By ID
            "1",  # adolescent#001
            "1",  # duplicate -> rejected with a message
            "d",  # done
            "1",  # Dexcom
            "7",  # cgm seed
            "2",  # Insulet
            "1",  # Basal-Bolus controller
        ]
    )
    with mock.patch("builtins.input", side_effect=lambda *a: next(answers)):
        df = ui_simulate()
    assert len(df.loc["adolescent#001"]) == 2 * 60 // 3 + 1


def test_engine_param_validation():
    """engine='pallas' needs a compiled kernel (a GPU) or an explicit
    interpret=True — these tests run on CPU, so it raises — and rejects
    configs only the general path supports; engine='auto' takes the XLA
    path without complaint."""
    import pytest

    from simglucose_tpu.sim.engine import _pallas_eligible
    from simglucose_tpu.analysis.risk import risk_diff_reward

    with pytest.raises(ValueError, match="backend 'cpu'"):
        simulate(
            sim_time=timedelta(hours=1),
            patient_names=["adolescent#001"],
            controller="BB",
            engine="pallas",
        )
    with pytest.raises(ValueError, match="engine"):
        simulate(sim_time=timedelta(hours=1), engine="nope")

    ok = lambda **kw: _pallas_eligible(
        **{
            "scenario": None,
            "controller": "BB",
            "animate": False,
            "substeps": 1,
            "dtype": np.float32,
            "reward_fun": risk_diff_reward,
            **kw,
        }
    )
    # custom scenarios ride the kernel's static meal schedule: a parseable
    # MealSpec is eligible, an unparseable one is not
    assert ok(scenario=[(7.0, 45)]) is None
    assert "scenario" in ok(scenario=[("breakfast", 45)])
    assert "animate" in ok(animate=True)
    assert "substeps" in ok(substeps=4)
    assert "dtype" in ok(dtype=np.float64)
    # custom rewards are ELIGIBLE: the frame has no reward column and the
    # plane is recomputed from the kernel's CGM planes (rewards_from_cgm)
    assert ok(reward_fun=lambda w, n: 0.0) is None
    assert "controller" in ok(controller=((), lambda s, r: None))
    # the kwarg whitelist is PER controller: BB takes only 'target' (the
    # XLA path's bb_policy raises on P/I/D), so ('BB', {'P': ...}) must be
    # ineligible — NOT silently run default therapy on the pallas engine
    assert "controller" in ok(controller=("BB", dict(P=-1e-4)))
    assert "controller" in ok(controller=("PID", dict(nope=1)))
    # valid per-controller kwargs are eligible
    assert ok(controller=("BB", dict(target=150.0))) is None
    assert ok(controller=("PID", dict(P=-2e-4, D=-1e-3))) is None
    assert ok() is None


def test_simulate_pallas_multidevice_interpret():
    """The pallas engine's multi-device branch: _simulate_pallas shards the
    kernel over the 8 virtual CPU devices under shard_map (interpret mode)
    and returns a well-formed cohort frame — the engine-level integration
    of make_sharded_pallas_rollout."""
    import jax

    from simglucose_tpu.sim.engine import _simulate_pallas

    assert jax.device_count() == 8
    names = ["adolescent#001", "adult#003", "child#005"]
    df = _simulate_pallas(
        names,
        "Dexcom",
        "Insulet",
        "PID",
        n_steps=2,
        start_min=0,
        random_init_bg=False,
        seed=3,
        start_time=datetime(2018, 1, 1),
        interpret=True,
    )
    assert set(df.index.get_level_values(0)) == set(names)
    sub = df.loc["adolescent#001"]
    assert len(sub) == 3  # reset row + 2 steps
    assert np.isfinite(sub.BG.to_numpy()).all()
    assert (sub.CGM.to_numpy() > 0).all()


def test_simulate_pallas_custom_scenario_interpret():
    """Custom meal scenarios stay on the kernel fast path: _simulate_pallas
    maps the MealSpec onto the kernel's static meal schedule
    (scenario_kind='static') and the announced meals land in the CHO column
    at the scheduled minutes (reference CustomScenario semantics,
    scenario.py:21-45)."""
    from simglucose_tpu.sim.engine import _simulate_pallas

    names = ["adolescent#001", "adult#003"]
    # meal at minute 3 -> step 1 at Dexcom's 3-min cadence (2 steps keeps
    # the 8-device interpret trace affordable; the kernel-level static
    # schedule is covered in depth by tests/test_pallas_rollout.py)
    df = _simulate_pallas(
        names,
        "Dexcom",
        "Insulet",
        "BB",
        n_steps=2,
        start_min=0,
        random_init_bg=False,
        seed=11,
        start_time=datetime(2018, 1, 1),
        interpret=True,
        scenario=[(0.05, 21.0)],
    )
    for name in names:
        cho = df.loc[name].CHO.to_numpy()  # reset row + 2 steps
        np.testing.assert_allclose(cho, [0.0, 0.0, 7.0])
        assert np.isfinite(df.loc[name].BG.to_numpy()).all()


def test_engine_auto_small_cohort_falls_back_off_tpu():
    """engine='auto' runs the XLA path on CPU at any cohort size (no
    compiled kernel there, and auto never picks the interpreter) — on a
    GPU the kernel is the default for ALL eligible configs."""
    df = simulate(
        sim_time=timedelta(hours=1),
        patient_names=["adolescent#001"],
        controller="PID",
        engine="auto",
    )
    assert len(df.loc["adolescent#001"]) == 60 // 3 + 1
    assert df.attrs["reward"].shape == (60 // 3, 1)


def test_rewards_from_cgm_matches_env_path():
    """The pallas engine's post-hoc reward recompute must equal the env
    path's in-loop rewards for the SAME CGM trajectory — for both the
    native 2-arg reward and a reference-style 1-arg reward (variable-length
    window semantics at episode start included)."""
    import jax

    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.functional import rewards_from_cgm
    from simglucose_tpu.envs.rollout import rollout_batch

    def custom_1arg(BG_last_hour):
        # trace-time Python over the variable-length window, like the
        # reference's risk_diff (simulation/env.py:26-32)
        if len(BG_last_hour) < 3:
            return 0.0
        return BG_last_hour[-1] - BG_last_hour[-3] + 0.01 * len(BG_last_hour)

    B, T = 3, 25
    cfg, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4)
    keys = jax.random.split(jax.random.PRNGKey(5), B)

    from simglucose_tpu.analysis.risk import risk_diff_reward
    from simglucose_tpu.envs.functional import wrap_reward_fn

    for rf in (risk_diff_reward, custom_1arg):
        rf_env = wrap_reward_fn(rf, cfg.window_size)  # what simulate() does
        _, reset_res, traj = jax.jit(
            lambda p, k: rollout_batch(
                cfg, p, k, ctrl0, ctrl, T, reward_fun=rf_env
            )
        )(params, keys)
        cgm0 = np.asarray(reset_res.CGM)  # [B] reset history sample
        cgm = np.asarray(traj.CGM).T  # [T, B]
        rec = jax.jit(
            lambda c0, c: rewards_from_cgm(rf, cfg.window_size, c0, c)
        )(cgm0, cgm)
        np.testing.assert_allclose(
            np.asarray(rec), np.asarray(traj.reward).T, rtol=1e-6, atol=1e-6
        )


def test_simulate_pallas_custom_reward_interpret():
    """simulate()'s pallas engine accepts a custom 1-arg reward_fun: the
    plane lands in df.attrs['reward'] and obeys the window law vs a direct
    recompute from the frame's CGM column."""
    import jax

    from simglucose_tpu.envs.functional import rewards_from_cgm
    from simglucose_tpu.sim.engine import _simulate_pallas

    def custom(BG_last_hour):
        if len(BG_last_hour) < 2:
            return 0.0
        return BG_last_hour[-2] - BG_last_hour[-1]

    names = ["adolescent#001", "adult#003"]
    df = _simulate_pallas(
        names,
        "Dexcom",
        "Insulet",
        "PID",
        n_steps=2,
        start_min=0,
        random_init_bg=False,
        seed=3,
        start_time=datetime(2018, 1, 1),
        interpret=True,
        reward_fun=custom,
    )
    r = df.attrs["reward"]
    assert r.shape == (2, 2)
    assert np.isfinite(r).all()
    for i, name in enumerate(names):
        cgm = df.loc[name].CGM.to_numpy()  # [reset, step1, step2]
        # window law: step1 sees [cgm0, cgm1] -> cgm0 - cgm1, etc.
        np.testing.assert_allclose(r[0, i], cgm[0] - cgm[1], rtol=1e-6)
        np.testing.assert_allclose(r[1, i], cgm[1] - cgm[2], rtol=1e-6)


def test_simulate_arrays_matches_frame():
    """simulate_arrays is simulate() without the frame: same values, [T, B]
    planes, the reset row apart."""
    from simglucose_tpu.sim.engine import simulate_arrays

    kw = dict(sim_time=timedelta(minutes=30),
              patient_names=["adolescent#001", "child#002"],
              controller="BB", scenario_seed=3, cgm_seed=4, engine="xla")
    arr = simulate_arrays(**kw)
    df = simulate(**kw)
    assert arr.engine == "xla" and arr.traj.BG.shape == (10, 2)
    for i, name in enumerate(kw["patient_names"]):
        sub = df.loc[name]
        np.testing.assert_allclose(sub.BG.to_numpy()[1:], arr.traj.BG[:, i])
        np.testing.assert_allclose(sub.BG.to_numpy()[0], arr.reset.BG[i])
        np.testing.assert_allclose(sub.CHO.to_numpy()[1:], arr.traj.CHO[:, i])
    np.testing.assert_allclose(df.attrs["reward"], arr.reward)


def test_simulate_pallas_chunked_long_horizon(monkeypatch):
    """Horizons whose output planes exceed PALLAS_MAX_OUTPUT_BYTES run as
    persistent_state chunks inside _simulate_pallas: one compiled program,
    state threaded between calls, planes concatenated and sliced to the
    requested horizon (bit-level chunk parity is pinned at kernel level by
    tests/test_pallas_rollout.py).  Forced here with a tiny byte bound so
    n_steps=6 runs as 3 chunks of 2 (2 patients padded to the 8 devices:
    6 planes x 4 bytes x 8 lanes per step)."""
    from simglucose_tpu.sim import engine as eng

    monkeypatch.setattr(eng, "PALLAS_MAX_OUTPUT_BYTES", 2 * 6 * 4 * 8)
    names = ["adolescent#001", "adult#003"]
    df = eng._simulate_pallas(
        names,
        "Dexcom",
        "Insulet",
        "PID",
        n_steps=6,
        start_min=0,
        random_init_bg=False,
        seed=3,
        start_time=datetime(2018, 1, 1),
        interpret=True,
    )
    assert set(df.index.get_level_values(0)) == set(names)
    for name in names:
        sub = df.loc[name]
        assert len(sub) == 7  # reset row + 6 steps
        bg = sub.BG.to_numpy()
        assert np.isfinite(bg).all()
        # state threads across chunk boundaries: no re-init jump at steps
        # 2->3 and 4->5 (a dropped carry would snap BG back toward x0)
        jumps = np.abs(np.diff(bg))
        assert jumps.max() < 25.0, jumps
    assert df.attrs["reward"].shape == (6, 2)
