"""REAL multi-process multi-host validation: two OS processes, each with 4
virtual CPU devices, form one global 8-device dp mesh via jax.distributed
(gloo collectives).  Each process runs the sharded cohort rollout, writes
its OWN host-local shard of the patient batch to per-patient CSVs (the
analog of the reference's per-worker writes, sim_engine.py:44-49), and the
combined results must equal the single-process rollout exactly — the
Multi-host version of the reference's parallel==serial contract
(tests/test_sim_engine.py:24-86).
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import os, sys
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from simglucose_tpu.parallel.multihost import initialize
    initialize(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc and jax.device_count() == 8

    import jax.numpy as jnp
    import numpy as np
    from datetime import datetime
    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import (
        batch_reset, broadcast_ctrl_state, make_batch_rollout_fn,
    )
    from simglucose_tpu.parallel.multihost import (
        local_batch_slice, local_shard, save_local_results,
    )
    from simglucose_tpu.parallel.sharding import make_mesh, shard_batch

    B, T = 16, 4
    names = cohort_names(B)
    cfg, params = make_env(names, batch=True, dtype=np.float32)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)

    mesh = make_mesh(dp=8, tp=1)
    params_s = shard_batch(params, mesh)
    keys_s = shard_batch(keys, mesh)
    state, res = jax.jit(lambda p, k: batch_reset(cfg, p, k))(params_s, keys_s)
    cs = shard_batch(broadcast_ctrl_state(ctrl0, B), mesh)
    run = make_batch_rollout_fn(cfg, ctrl, n_steps=T, donate=False)
    _, _, traj = run(params_s, state, cs, res)

    # global metric reduction across the whole mesh (crosses both processes)
    gmean = float(jax.jit(lambda t: jnp.mean(t.CGM))(traj))

    # per-host result IO: this host's 8 patients only
    df = save_local_results(
        (res, traj), names, datetime(2018, 1, 1), cfg.sample_time, outdir
    )
    sl = local_batch_slice(B)
    local_bg = local_shard(traj).BG  # [T, B/2]
    np.savez(
        os.path.join(outdir, f"proc{pid}.npz"),
        BG=np.asarray(local_bg), lo=sl.start, hi=sl.stop, gmean=gmean,
    )
    print(f"proc {pid} OK", flush=True)
    """
)


WORKER_PPO = textwrap.dedent(
    """
    import os, sys
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from simglucose_tpu.parallel.multihost import initialize
    initialize(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc and jax.device_count() == 8

    import numpy as np
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import batch_reset
    from simglucose_tpu.parallel.sharding import make_mesh, replicate, shard_batch
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import (
        PPOConfig, TrainState, make_optimizer, make_train_step,
    )

    B = 16
    cfg, env_params = make_env(
        cohort_names(B), batch=True, random_init_bg=True, dtype=np.float32
    )
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(dp=8, tp=1)
    env_params_s = shard_batch(env_params, mesh)
    keys_s = shard_batch(jax.random.split(key, B), mesh)
    env_state, reset_res = jax.jit(lambda p, k: batch_reset(cfg, p, k))(
        env_params_s, keys_s
    )

    ppo_cfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=2)
    policy = init_policy(jax.random.fold_in(key, 1), hidden=32)
    ts = TrainState(
        params=replicate(policy, mesh),
        opt_state=replicate(make_optimizer(ppo_cfg).init(policy), mesh),
        env_state=env_state,
        prev_res=reset_res,
        key=replicate(key, mesh),
    )
    train_step = jax.jit(make_train_step(ppo_cfg, cfg, mesh=mesh))
    with mesh:
        ts2, metrics = train_step(env_params_s, ts)
    for k, v in metrics.items():
        assert np.isfinite(float(v)), k
    # replicated post-update params are fully addressable on every host
    leaves = [np.asarray(x) for x in jax.tree.leaves(ts2.params)]
    init_leaves = [np.asarray(x) for x in jax.tree.leaves(policy)]
    np.savez(
        os.path.join(outdir, f"ppo{pid}.npz"),
        reward_mean=float(metrics["reward_mean"]),
        **{f"leaf_{i}": a for i, a in enumerate(leaves)},
        **{f"init_{i}": a for i, a in enumerate(init_leaves)},
    )
    print(f"ppo proc {pid} OK", flush=True)
    """
)


WORKER_FUSED = textwrap.dedent(
    """
    import os, sys
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from simglucose_tpu.parallel.multihost import initialize
    initialize(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc and jax.device_count() == 8

    import numpy as np
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import pack_params
    from simglucose_tpu.parallel.sharding import make_mesh
    from simglucose_tpu.rl.fused import init_fused_state, make_fused_train_step
    from simglucose_tpu.rl.policy import init_policy
    from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer
    from jax.sharding import NamedSharding, PartitionSpec as P

    B = 4096  # 512 patients (4 lane rows) per device = 2048 per HOST
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(dp=8, tp=1)
    _, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
    packed = jax.device_put(
        pack_params(params.patient, basal_rate(params.patient)),
        NamedSharding(mesh, P(None, "dp")),
    )
    # the XLA learner under the dp mesh: GSPMD's gradient all-reduce
    # crosses the PROCESS boundary — the fused trainer at a realistic
    # per-host shard
    cfg = PPOConfig(rollout_steps=2, epochs=1, minibatches=2)
    policy = init_policy(
        jax.random.fold_in(key, 1), hidden=16, init_mu_bias=-2.2, act="relu"
    )
    ts = init_fused_state(
        policy, make_optimizer(cfg).init(policy), B, key, mesh=mesh
    )
    step = make_fused_train_step(
        cfg, B, hidden=16, interpret=True, mesh=mesh,
    )
    with mesh:
        ts1, m = step(packed, ts)
    rew = float(m["reward_mean"])
    assert np.isfinite(rew)
    # replicated post-update params are fully addressable on every host
    leaves = [np.asarray(x) for x in jax.tree.leaves(ts1.params)]
    init_leaves = [np.asarray(x) for x in jax.tree.leaves(policy)]
    # this host's shard of the persistent simulator state advanced
    local_ti = np.concatenate([
        np.asarray(s.data) for s in ts1.state_i[0].addressable_shards
    ], axis=0)
    np.savez(
        os.path.join(outdir, f"fused{pid}.npz"),
        reward_mean=rew, t_min_max=int(local_ti.max()),
        **{f"leaf_{i}": a for i, a in enumerate(leaves)},
        **{f"init_{i}": a for i, a in enumerate(init_leaves)},
    )
    print(f"fused proc {pid} OK", flush=True)
    """
)


WORKER_SCALE = textwrap.dedent(
    """
    import os, sys
    pid, nproc, port, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from simglucose_tpu.parallel.multihost import initialize
    initialize(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc and jax.device_count() == 8

    import jax.numpy as jnp
    import numpy as np
    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import (
        batch_reset, broadcast_ctrl_state, make_batch_rollout_fn,
    )
    from simglucose_tpu.parallel.multihost import local_batch_slice, local_shard
    from simglucose_tpu.parallel.sharding import make_mesh, shard_batch

    # realistic per-host shard: 2048 patients per process; short T keeps it inside the CI budget
    B, T = 4096, 2
    names = cohort_names(B)
    cfg, params = make_env(names, batch=True, dtype=np.float32)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)

    mesh = make_mesh(dp=8, tp=1)
    params_s = shard_batch(params, mesh)
    keys_s = shard_batch(keys, mesh)
    state, res = jax.jit(lambda p, k: batch_reset(cfg, p, k))(params_s, keys_s)
    cs = shard_batch(broadcast_ctrl_state(ctrl0, B), mesh)
    run = make_batch_rollout_fn(cfg, ctrl, n_steps=T, donate=False)
    _, _, traj = run(params_s, state, cs, res)

    gmean = float(jax.jit(lambda t: jnp.mean(t.CGM))(traj))
    sl = local_batch_slice(B)
    local_bg = local_shard(traj).BG  # [T, B/2]
    assert local_bg.shape[1] == B // nproc
    np.savez(
        os.path.join(outdir, f"scale{pid}.npz"),
        BG=np.asarray(local_bg), lo=sl.start, hi=sl.stop, gmean=gmean,
    )
    print(f"scale proc {pid} OK", flush=True)
    """
)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_ppo_learner_identical_params(tmp_path):
    """BASELINE config 5 (multi-host sharded PPO learner): one train_step
    across a 2-process gloo dp mesh — the gradient all-reduce contract is
    that BOTH hosts hold bit-identical replicated post-update params."""
    port = _free_port()
    worker = tmp_path / "worker_ppo.py"
    worker.write_text(WORKER_PPO)
    outdir = tmp_path / "results"
    outdir.mkdir()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), str(outdir)],
            env=env,
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"ppo worker failed:\n{out[-3000:]}"

    z0 = np.load(outdir / "ppo0.npz")
    z1 = np.load(outdir / "ppo1.npz")
    n_leaves = len([k for k in z0.files if k.startswith("leaf_")])
    assert n_leaves > 0
    changed = False
    for i in range(n_leaves):
        # both hosts computed the SAME update (gradient all-reduce agreed)
        np.testing.assert_array_equal(
            z0[f"leaf_{i}"], z1[f"leaf_{i}"], err_msg=f"leaf {i}"
        )
        changed = changed or not np.array_equal(
            z0[f"leaf_{i}"], z0[f"init_{i}"]
        )
    assert changed, "train step must actually update the params"
    assert z0["reward_mean"] == z1["reward_mean"]


def test_two_process_fused_trainer_identical_params(tmp_path):
    """The PRODUCTION training path (rl/fused.py: pallas 'nn' actor +
    XLA learner) across a 2-process gloo dp mesh — BASELINE config 5 at
    process scope, not just the single-process dryrun.  Both hosts must
    hold bit-identical replicated post-update params (the GSPMD gradient
    all-reduce contract), and each host's shard of the persistent
    simulator state must have advanced (episodes continue across
    iterations).  Reference analog: sim_engine.py:65-76 scaled across
    hosts."""
    port = _free_port()
    worker = tmp_path / "worker_fused.py"
    worker.write_text(WORKER_FUSED)
    outdir = tmp_path / "results"
    outdir.mkdir()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), str(outdir)],
            env=env,
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"fused worker failed:\n{out[-3000:]}"

    z0 = np.load(outdir / "fused0.npz")
    z1 = np.load(outdir / "fused1.npz")
    n_leaves = len([k for k in z0.files if k.startswith("leaf_")])
    assert n_leaves > 0
    changed = False
    for i in range(n_leaves):
        np.testing.assert_array_equal(
            z0[f"leaf_{i}"], z1[f"leaf_{i}"], err_msg=f"leaf {i}"
        )
        changed = changed or not np.array_equal(
            z0[f"leaf_{i}"], z0[f"init_{i}"]
        )
    assert changed, "fused train step must actually update the params"
    assert z0["reward_mean"] == z1["reward_mean"]
    # persistent kernel state advanced on both hosts' local shards
    assert int(z0["t_min_max"]) > 0 and int(z1["t_min_max"]) > 0


def test_two_process_sharded_rollout_matches_single_process(tmp_path):
    port = _free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    outdir = tmp_path / "results"
    outdir.mkdir()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), str(outdir)],
            env=env,
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    # every host wrote its own shard: 16 per-patient CSVs total
    from simglucose_tpu.envs.build import cohort_names

    names = cohort_names(16)
    csvs = {f.name for f in outdir.iterdir() if f.suffix == ".csv"}
    assert csvs == {f"{n}.csv" for n in names}

    # single-process reference rollout (this pytest process: 8 virtual devs)
    import jax

    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.build import make_env
    from simglucose_tpu.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_rollout_fn,
    )

    B, T = 16, 4
    cfg, params = make_env(names, batch=True, dtype=np.float32)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys)
    cs = broadcast_ctrl_state(ctrl0, B)
    run = make_batch_rollout_fn(cfg, ctrl, n_steps=T, donate=False)
    _, _, traj = run(params, state, cs, res)
    ref_bg = np.asarray(traj.BG)

    # the two hosts' shards reassemble the exact single-process trace
    got = np.full_like(ref_bg, np.nan)
    gmeans = []
    for i in range(2):
        z = np.load(outdir / f"proc{i}.npz")
        got[:, int(z["lo"]) : int(z["hi"])] = z["BG"]
        gmeans.append(float(z["gmean"]))
    np.testing.assert_array_equal(got, ref_bg)
    # the cross-process global reduction agrees between hosts and with ref
    assert gmeans[0] == gmeans[1]
    np.testing.assert_allclose(
        gmeans[0], float(np.asarray(traj.CGM).mean()), rtol=1e-6
    )


def test_two_process_sharded_rollout_at_scale(tmp_path):
    """Realistic per-host shard: 4096 patients over
    the 2-process gloo mesh — 2048 lanes per process — with the shards
    reassembling the exact single-process trace and the cross-process CGM
    reduction agreeing between hosts and with the reference run."""
    port = _free_port()
    worker = tmp_path / "worker_scale.py"
    worker.write_text(WORKER_SCALE)
    outdir = tmp_path / "results"
    outdir.mkdir()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port), str(outdir)],
            env=env,
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"scale worker failed:\n{out[-3000:]}"

    import jax

    from simglucose_tpu.controllers.functional import pid_controller
    from simglucose_tpu.envs.build import cohort_names, make_env
    from simglucose_tpu.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_rollout_fn,
    )

    B, T = 4096, 2
    cfg, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
    ctrl0, ctrl = pid_controller(cfg.sample_time, P=-1e-4, I=-1e-7)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, res = batch_reset(cfg, params, keys)
    cs = broadcast_ctrl_state(ctrl0, B)
    run = make_batch_rollout_fn(cfg, ctrl, n_steps=T, donate=False)
    _, _, traj = run(params, state, cs, res)
    ref_bg = np.asarray(traj.BG)

    got = np.full_like(ref_bg, np.nan)
    gmeans = []
    for i in range(2):
        z = np.load(outdir / f"scale{i}.npz")
        assert int(z["hi"]) - int(z["lo"]) == B // 2  # 2048 lanes/process
        got[:, int(z["lo"]) : int(z["hi"])] = z["BG"]
        gmeans.append(float(z["gmean"]))
    np.testing.assert_array_equal(got, ref_bg)
    assert gmeans[0] == gmeans[1]
    np.testing.assert_allclose(
        gmeans[0], float(np.asarray(traj.CGM).mean()), rtol=1e-6
    )
