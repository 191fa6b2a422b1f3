"""High-level simulation engine: the user-facing batch-simulation API.

Capability parity with the reference's sim engine + ``simulate()`` entry
(reference: simulation/sim_engine.py:15-76, simulation/user_interface.py:303-385),
re-designed for an accelerator: the whole patient cohort runs as ONE
compiled program (the Pallas rollout kernel on a GPU, ``jit(vmap(scan))``
elsewhere) instead of a process pool — "parallel" is the default and costs
nothing.

Main entry: :func:`simulate` — programmatic, returns the reference-style
multi-index results frame and optionally writes per-patient CSVs + the full
analysis report.  :class:`SimObj`/:func:`sim`/:func:`batch_sim` are thin
familiar shims over the same machinery.
"""
from __future__ import annotations

import logging
import os
import time
from datetime import datetime, timedelta
from typing import Callable, NamedTuple, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from simglucose_tpu import params as tables
from simglucose_tpu.analysis.risk import risk_diff_reward
from simglucose_tpu.controllers.functional import (
    BBParams,
    bb_params,
    bb_policy,
    pid_controller,
)
from simglucose_tpu.envs.build import make_env
from simglucose_tpu.envs.gym_env import MealSpec, parse_meal_times
from simglucose_tpu.envs.rollout import rollout_batch
from simglucose_tpu.ops.backend import XLA, kernel_mode

logger = logging.getLogger(__name__)


class _FrameFields(NamedTuple):
    """The pytree shape trajectory_frame/cohort_frame consume."""

    BG: np.ndarray
    CGM: np.ndarray
    CHO: np.ndarray
    insulin: np.ndarray
    LBGI: np.ndarray
    HBGI: np.ndarray
    risk: np.ndarray


def _resolve_controller(controller, cfg, env_params, patient_names, dtype):
    """Accept 'BB'/'PID' (optionally with kwargs), a (ctrl_init, ctrl_fn)
    pair, or a pair factory.

    PID gains are configurable per run — the reference exposes P/I/D on the
    controller constructor (reference: controller/pid_ctrller.py:9-15):
    pass ``('PID', dict(P=..., I=..., D=..., target=...))`` or
    ``{'PID': {...}}``.  Likewise ``('BB', dict(target=...))``.

    Returns (ctrl_init, ctrl_fn, ctrl_in_axes)."""
    controller, kwargs = _controller_spec(controller)

    if controller is None or (
        isinstance(controller, str) and controller.upper() in ("BB", "BASAL-BOLUS")
    ):
        quest = tables.load_quest_params(patient_names, dtype=dtype)
        bb = bb_params(env_params.patient, quest)
        return bb, bb_policy(cfg.sample_time, **kwargs), 0
    if isinstance(controller, str) and controller.upper() == "PID":
        gains = dict(P=-1e-4, I=-1e-7, D=0.0)
        gains.update(kwargs)
        init, fn = pid_controller(cfg.sample_time, dtype=dtype, **gains)
        return init, fn, None
    if isinstance(controller, tuple) and len(controller) == 2:
        init, fn = controller
        return init, fn, None
    if isinstance(controller, tuple) and len(controller) == 3:
        # (init, policy, in_axes): per-patient controller state (e.g.
        # rl/evaluate.policy_controller with basal scaling)
        return controller
    raise ValueError(
        f"controller must be 'BB', 'PID' (optionally ('PID', kwargs) / "
        f"{{'PID': kwargs}}), an (init, policy) pair, or an "
        f"(init, policy, in_axes) triple; got {controller!r}"
    )


def _controller_spec(controller):
    """Normalize a controller spec to (name_or_None_or_object, kwargs)."""
    if isinstance(controller, dict) and len(controller) == 1:
        (name, kwargs), = controller.items()
        return name, dict(kwargs)
    if (
        isinstance(controller, tuple)
        and len(controller) == 2
        and isinstance(controller[0], str)
        and isinstance(controller[1], dict)
    ):
        return controller[0], dict(controller[1])
    return controller, {}


def _pallas_eligible(
    scenario, controller, animate, substeps, dtype, reward_fun
) -> Optional[str]:
    """None if the pallas single-kernel engine can run this config, else the
    reason it can't."""
    if scenario is not None and not (
        isinstance(scenario, str) and scenario == "random"
    ):
        # custom scenarios ride the kernel's static meal schedule
        # (scenario_kind='static', ops/pallas_rollout.py) as long as they
        # parse to the reference MealSpec forms (scenario.py:48-59)
        try:
            parse_meal_times(scenario, datetime(2018, 1, 1))
        except (TypeError, ValueError):
            return "an unparseable custom scenario"
    if animate:
        return "animate=True (incremental host rendering)"
    if substeps != 1:
        return f"substeps={substeps} (kernel is rk4/substeps=1)"
    if dtype != np.float32:
        return f"dtype={np.dtype(dtype).name} (kernel is float32)"
    # reward_fun is NOT a blocker: the results frame has no reward column
    # (reference schema, env.py:169-180) and the eligible controllers
    # (BB/PID) never read the reward, so any window-based reward_fun is
    # recomputed in XLA from the kernel's CGM planes after the rollout
    # (envs/functional.rewards_from_cgm) and attached as
    # ``df.attrs['reward']`` — identical to what the env path would emit
    # for the same CGM values.
    del reward_fun
    ctrl_name, ctrl_kwargs = _controller_spec(controller)
    # kwarg whitelist is PER CONTROLLER: BB accepts only 'target' (the XLA
    # path's bb_policy raises on P/I/D), so ('BB', {'P': ...}) must NOT be
    # deemed eligible and silently dropped — both engines must accept
    # exactly the same specs
    known_kw = {"BB": {"target"}, "BASAL-BOLUS": {"target"},
                "PID": {"P", "I", "D", "target"}}
    if not (
        ctrl_name is None
        or (
            isinstance(ctrl_name, str)
            and ctrl_name.upper() in known_kw
            and set(ctrl_kwargs) <= known_kw[ctrl_name.upper()]
        )
    ):
        return "a custom controller"
    return None


class CohortArrays(NamedTuple):
    """A cohort simulation as arrays — what :func:`simulate` turns into the
    results frame.  ``reset`` holds the [B] reset row, ``traj`` the [T, B]
    step rows; ``engine`` names the engine that ran ('pallas' or 'xla')."""

    reset: _FrameFields
    traj: _FrameFields
    reward: np.ndarray  # [T, B]
    sample_time: int
    engine: str


_PALLAS_RUN_CACHE: dict = {}
_REWARD_JIT_CACHE: dict = {}
# Both caches pin compiled executables; a sweep over horizons / cohort
# sizes / controller gains must not grow process memory without bound, so
# insertion evicts the least recently used entry beyond these sizes.
_PALLAS_CACHE_MAX = 16
_REWARD_CACHE_MAX = 32

# Device bytes of trajectory planes (6 f32 [T, B] planes) one kernel call
# may hold.  Longer horizons run as equal chunks threading the kernel's
# persistent_state, gathered to the host chunk by chunk, so device memory
# is bounded by the chunk, not the horizon (the reference's sim_time is
# unbounded, sim_engine.py:29-39).  Chunked runs are bit-identical to one
# call: chunk c passes step0 = c * steps_per_call and the kernel's random
# streams are a function of the global step.
PALLAS_MAX_OUTPUT_BYTES = 1 << 30


def _cache_put(cache: dict, key, val, maxsize: int):
    while len(cache) >= maxsize:
        cache.pop(next(iter(cache)))
    cache[key] = val


def _pallas_horizon(n_steps: int, batch: int):
    """(steps_per_call, n_calls) for a kernel horizon: one call when its
    output planes fit PALLAS_MAX_OUTPUT_BYTES, else equal full-size chunks
    (the tail chunk's surplus steps are sliced off after the run — one
    compiled program instead of two)."""
    m = max(1, PALLAS_MAX_OUTPUT_BYTES // (6 * 4 * batch))
    if n_steps <= m:
        return n_steps, 1
    return m, -(-n_steps // m)


def _pallas_cfg(
    patient_names, cgm_name, insulin_pump_name, controller, n_steps,
    start_min, random_init_bg, start_time, scenario,
):
    """The kernel configuration simulate() runs this request with.
    Returns (cfg, padded_batch, padded_names, n_dev, n_calls)."""
    from simglucose_tpu.ops.pallas_rollout import config_for_sensor

    n_dev = jax.device_count()
    B = len(patient_names)
    # pad the cohort to a multiple of the device count (the kernel pads
    # each device's lanes to its block itself; results are sliced back)
    padded = -(-B // n_dev) * n_dev
    names_p = [patient_names[i % B] for i in range(padded)]
    n_steps, n_calls = _pallas_horizon(n_steps, padded)

    pump = tables.pump_record(insulin_pump_name)
    ctrl_name, ctrl_kwargs = _controller_spec(controller)
    ctrl_kind = (
        "pid"
        if (isinstance(ctrl_name, str) and ctrl_name.upper() == "PID")
        else "bb"
    )
    ctrl_fields = {}
    if ctrl_kind == "pid":
        gains = dict(P=-1e-4, I=-1e-7, D=0.0, target=140.0)
        gains.update(ctrl_kwargs)
        ctrl_fields = dict(
            pid_p=float(gains["P"]), pid_i=float(gains["I"]),
            pid_d=float(gains["D"]), pid_target=float(gains["target"]),
        )
    elif "target" in ctrl_kwargs:
        ctrl_fields = dict(bb_target=float(ctrl_kwargs["target"]))
    scenario_fields = {}
    if scenario is not None and not isinstance(scenario, str):
        # CustomScenario -> the kernel's static meal schedule (absolute
        # episode minutes; noise/init randomness unaffected) — the fast-path
        # analog of the reference CustomScenario (scenario.py:21-45)
        t_arr, a_arr = parse_meal_times(scenario, start_time)
        scenario_fields = dict(
            scenario_kind="static",
            det_meal_times=tuple(int(t) for t in t_arr),
            det_meal_amounts=tuple(float(a) for a in a_arr),
        )
    cfg = config_for_sensor(
        cgm_name,
        n_steps=n_steps,
        controller=ctrl_kind,
        **ctrl_fields,
        **scenario_fields,
        inc_basal=float(pump["inc_basal"]),
        min_basal=float(pump["min_basal"]),
        max_basal=float(pump["max_basal"]),
        inc_bolus=float(pump["inc_bolus"]),
        min_bolus=float(pump["min_bolus"]),
        max_bolus=float(pump["max_bolus"]),
        random_init_bg=random_init_bg,
        autoreset=False,
        fixed_start_min=start_min,
        # multi-call horizons thread the simulator state between calls
        persistent_state=n_calls > 1,
    )
    return cfg, padded, names_p, n_dev, n_calls


def _cached_pallas_run(cfg, padded: int, n_dev: int, interpret: bool):
    """Process-cached jitted kernel call for one simulate() configuration
    (LRU): a sweep that repeats a configuration compiles it once.  The
    persistent form takes ``(packed, seed, state, init, step0)``."""
    key = (cfg, padded, n_dev, interpret)
    fn = _PALLAS_RUN_CACHE.pop(key, None)
    if fn is None:
        from simglucose_tpu.ops.pallas_rollout import (
            make_pallas_rollout,
            make_sharded_pallas_rollout,
        )

        if n_dev > 1:
            from simglucose_tpu.parallel.sharding import make_mesh

            run = make_sharded_pallas_rollout(
                cfg, padded, make_mesh(dp=n_dev, tp=1), interpret=interpret
            )
        else:
            run = make_pallas_rollout(cfg, padded, interpret=interpret)
        if cfg.persistent_state:
            fn = jax.jit(
                lambda p, s, state, init, step0: run(
                    p, s, state=state, init=init, step0=step0
                )
            )
        else:
            fn = jax.jit(lambda p, s: run(p, s))
    # re-insert on every use so eviction drops the least recently used
    _cache_put(_PALLAS_RUN_CACHE, key, fn, _PALLAS_CACHE_MAX)
    return fn


def _simulate_pallas_arrays(
    patient_names,
    cgm_name,
    insulin_pump_name,
    controller,
    n_steps,
    start_min,
    random_init_bg,
    seed,
    start_time,
    interpret=False,
    scenario=None,
    reward_fun=risk_diff_reward,
) -> CohortArrays:
    """Cohort simulation on the single-kernel pallas engine
    (ops/pallas_rollout.py).  Fixed horizon, no auto-reset — the reference
    batch_sim semantics (sim_engine.py:29-39).

    On multi-device backends the kernel runs under shard_map over a dp mesh
    (one kernel instance per device, zero rollout communication —
    ops/pallas_rollout.py make_sharded_pallas_rollout).

    Horizons whose output planes exceed ``PALLAS_MAX_OUTPUT_BYTES`` run as
    equal chunks threading the kernel's ``persistent_state`` — ONE
    compiled program reused across chunks, gathered to the host per chunk.
    Chunked trajectories are BIT-identical to one call: chunk c runs with
    ``step0 = c * steps_per_call`` and the kernel's random streams are a
    function of (seed, lane, global step) (tests/test_sim_api.py
    chunked test, tests/test_pallas_rollout.py chunk-parity test)."""
    from simglucose_tpu.analysis.risk import risk_scalar
    from simglucose_tpu.models.uva_padova import basal_rate
    from simglucose_tpu.ops.pallas_rollout import NS_F, NS_I, pack_params

    B = len(patient_names)
    cfg, padded, names_p, n_dev, n_calls = _pallas_cfg(
        patient_names, cgm_name, insulin_pump_name, controller, n_steps,
        start_min, random_init_bg, start_time, scenario,
    )
    patient = tables.load_patient_params(names_p, dtype=np.float32)
    quest = tables.load_quest_params(names_p, dtype=np.float32)
    packed = pack_params(patient, basal_rate(patient), quest=quest)
    shard = None
    if n_dev > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from simglucose_tpu.parallel.sharding import make_mesh

        shard = NamedSharding(make_mesh(dp=n_dev, tp=1), P(None, "dp"))
        packed = jax.device_put(packed, shard)
    runner = _cached_pallas_run(cfg, padded, n_dev, interpret)
    risk_fn = jax.jit(risk_scalar)
    plane_keys = ("BG", "CGM", "CHO", "insulin")
    acc = {k: [] for k in plane_keys + ("LBGI", "HBGI", "risk")}
    if n_calls == 1:
        chunks = [runner(packed, seed)]
    else:
        # state threads through ONE compiled program (explicit zero state
        # + traced init on the first call keeps the signature — and hence
        # the compilation — identical across chunks)
        state = (
            jnp.zeros((NS_F, padded), jnp.float32),
            jnp.zeros((NS_I, padded), jnp.int32),
        )
        if shard is not None:
            state = tuple(jax.device_put(s, shard) for s in state)
        chunks = []
        for c in range(n_calls):
            traj = runner(
                packed, seed, state, 1 if c == 0 else 0, c * cfg.n_steps
            )
            state = (traj["state_f"], traj["state_i"])
            chunks.append(traj)
    bg0, cgm0 = chunks[0]["BG0"], chunks[0]["CGM0"]
    for traj in chunks:
        L, H, RI = risk_fn(traj["BG"])
        for k in plane_keys:
            acc[k].append(np.asarray(traj[k]))
        acc["LBGI"].append(np.asarray(L))
        acc["HBGI"].append(np.asarray(H))
        acc["risk"].append(np.asarray(RI))
    planes = {k: np.concatenate(v, axis=0)[:n_steps] for k, v in acc.items()}
    L0, H0, R0 = risk_fn(bg0)
    # per-step rewards recomputed in XLA from the kernel's CGM planes with
    # the exact ring-buffer window law (envs/functional.rewards_from_cgm) —
    # this is what makes ANY window-based reward_fun pallas-eligible.
    # The jitted recompute is cached per (reward_fun, window): a fresh
    # lambda per call would re-trace the W-branch reward switch every
    # simulate() (measured ~2s at W=60).
    from simglucose_tpu.envs.functional import (
        reward_window_size,
        rewards_from_cgm,
    )

    W = reward_window_size(cfg.sample_time)
    rkey = (reward_fun, W)
    rfn = _REWARD_JIT_CACHE.get(rkey)
    if rfn is None:
        rfn = jax.jit(
            lambda c0, c: rewards_from_cgm(reward_fun, W, c0, c)
        )
        _cache_put(_REWARD_JIT_CACHE, rkey, rfn, _REWARD_CACHE_MAX)
    rewards = rfn(cgm0, planes["CGM"])

    host = lambda a: np.asarray(a)[..., :B]
    zeros = np.zeros(B, np.float32)
    traj_ns = _FrameFields(**{k: host(planes[k]) for k in _FrameFields._fields})
    reset_ns = _FrameFields(
        BG=host(bg0), CGM=host(cgm0), CHO=zeros, insulin=zeros,
        LBGI=host(L0), HBGI=host(H0), risk=host(R0),
    )
    return CohortArrays(
        reset=reset_ns, traj=traj_ns, reward=host(rewards),
        sample_time=cfg.sample_time, engine="pallas",
    )


def _frame(arrays: CohortArrays, patient_names, start_time):
    """CohortArrays -> the reference-style multi-index results frame, with
    the reward plane as ``df.attrs['reward']`` ([T, B])."""
    from simglucose_tpu.analysis.report import cohort_frame

    df = cohort_frame(
        arrays.reset, arrays.traj, patient_names, start_time,
        arrays.sample_time,
    )
    df.attrs["reward"] = arrays.reward
    return df


def _simulate_pallas(patient_names, *args, start_time, **kwargs):
    """:func:`_simulate_pallas_arrays` as the results frame."""
    arrays = _simulate_pallas_arrays(
        patient_names, *args, start_time=start_time, **kwargs
    )
    return _frame(arrays, patient_names, start_time)


def _xla_setup(
    sim_time, scenario, scenario_seed, controller, patient_names, cgm_name,
    cgm_seed, insulin_pump_name, start_time, random_init_bg, dtype,
    substeps, reward_fun, compat_mode,
):
    """Env, controller and keys of the general XLA engine."""
    B = len(patient_names)
    custom_times = custom_amounts = None
    scenario_mode = "random"
    if scenario is not None and not isinstance(scenario, str):
        t_arr, a_arr = parse_meal_times(scenario, start_time)
        custom_times = np.broadcast_to(t_arr, (B,) + t_arr.shape)
        custom_amounts = np.broadcast_to(
            a_arr.astype(dtype), (B,) + a_arr.shape
        )
        scenario_mode = "custom"

    noise_seq = meal_seq = None
    method = "rk4"
    if compat_mode:
        # MT19937-bit-exact pregeneration, shared across the cohort like the
        # reference (same cgm_seed sensor + deepcopied scenario per patient,
        # user_interface.py:364-372)
        from simglucose_tpu.compat.noise import reference_cgm_noise
        from simglucose_tpu.compat.scenario import reference_meal_seq

        method = "rk45"
        st = tables.sensor_sample_time(cgm_name)
        n_min = int(sim_time.total_seconds() // 60)
        noise_seq = reference_cgm_noise(
            tables.sensor_record(cgm_name), int(cgm_seed), n_min // st + 4
        )
        if scenario_mode == "random":
            meal_seq = reference_meal_seq(
                int(scenario_seed), start_time, n_min + st
            )
            scenario_mode = "exogenous"

    cfg, env_params = make_env(
        patient_names,
        sensor=cgm_name,
        pump=insulin_pump_name,
        dtype=dtype,
        batch=True,
        substeps=substeps,
        method=method,
        noise_seq=noise_seq,
        meal_seq=meal_seq,
        scenario_mode=scenario_mode,
        random_init_bg=random_init_bg,
    )
    if custom_times is not None:
        env_params = env_params._replace(
            custom_times=jnp.asarray(custom_times, jnp.int32),
            custom_amounts=jnp.asarray(custom_amounts),
        )

    ctrl_init, ctrl_fn, ctrl_axes = _resolve_controller(
        controller, cfg, env_params, patient_names, dtype
    )
    # reference-style 1-arg reward fns get exact variable-length semantics
    from simglucose_tpu.envs.functional import wrap_reward_fn

    reward_fun = wrap_reward_fn(reward_fun, cfg.window_size)

    n_steps = int(sim_time.total_seconds() // 60) // cfg.sample_time
    seed = 0 if scenario_seed is None else int(scenario_seed)
    base = jax.random.PRNGKey(seed)
    if cgm_seed is not None:
        base = jax.random.fold_in(base, int(cgm_seed))
    keys = jax.random.split(base, B)
    start_min = (start_time.hour * 60 + start_time.minute) % 1440
    return (cfg, env_params, ctrl_init, ctrl_fn, ctrl_axes, reward_fun,
            keys, n_steps, start_min)


def _simulate_xla_arrays(*setup_args) -> CohortArrays:
    (cfg, env_params, ctrl_init, ctrl_fn, ctrl_axes, reward_fun, keys,
     n_steps, start_min) = _xla_setup(*setup_args)
    # pregen (hoisting the noise/meal streams out of the scan,
    # envs/rollout.py) is bit-identical; the general streaming path is
    # kept here and the pallas kernel is the fast path
    run = jax.jit(
        lambda p, k, ci: rollout_batch(
            cfg,
            p,
            k,
            ci,
            ctrl_fn,
            n_steps,
            start_min=start_min,
            reward_fun=reward_fun,
            ctrl_in_axes=ctrl_axes,
            pregen=False,
        )
    )
    _, reset_res, traj = run(env_params, keys, ctrl_init)
    pick = lambda r, f: np.asarray(getattr(r, f))
    # [B, T] -> [T, B] like the kernel planes
    return CohortArrays(
        reset=_FrameFields(**{f: pick(reset_res, f) for f in _FrameFields._fields}),
        traj=_FrameFields(
            **{f: pick(traj, f).swapaxes(0, 1) for f in _FrameFields._fields}
        ),
        reward=np.asarray(traj.reward).swapaxes(0, 1),
        sample_time=cfg.sample_time,
        engine="xla",
    )


def simulate_arrays(
    sim_time: timedelta = timedelta(days=1),
    scenario: Optional[Union[str, MealSpec]] = None,
    scenario_seed: Optional[int] = None,
    controller=None,
    patient_names: Optional[Sequence[str]] = None,
    cgm_name: str = "Dexcom",
    cgm_seed: Optional[int] = None,
    insulin_pump_name: str = "Insulet",
    start_time: Optional[datetime] = None,
    random_init_bg: bool = False,
    dtype=np.float32,
    substeps: int = 1,
    reward_fun: Callable = risk_diff_reward,
    engine: str = "auto",
    compat_mode: bool = False,
    interpret: bool = False,
    animate: bool = False,
) -> CohortArrays:
    """:func:`simulate` without the results frame: the cohort as arrays
    (:class:`CohortArrays`), with no pandas involved.  Same arguments and
    engine choice as :func:`simulate`."""
    if compat_mode:
        engine, dtype, substeps, random_init_bg = _compat_args(
            engine, scenario, scenario_seed, cgm_seed
        )
    patient_names, start_time = _names_and_start(patient_names, start_time)
    if _use_kernel(
        engine, interpret, scenario, controller, animate, substeps, dtype,
        reward_fun,
    ):
        n_steps = int(sim_time.total_seconds() // 60) // tables.sensor_sample_time(cgm_name)
        seed = (0 if scenario_seed is None else int(scenario_seed)) * 1000003 + (
            0 if cgm_seed is None else int(cgm_seed)
        )
        return _simulate_pallas_arrays(
            patient_names,
            cgm_name,
            insulin_pump_name,
            controller,
            n_steps,
            (start_time.hour * 60 + start_time.minute) % 1440,
            random_init_bg,
            seed,
            start_time,
            interpret=interpret,
            scenario=scenario,
            reward_fun=reward_fun,
        )
    return _simulate_xla_arrays(
        sim_time, scenario, scenario_seed, controller, patient_names,
        cgm_name, cgm_seed, insulin_pump_name, start_time, random_init_bg,
        dtype, substeps, reward_fun, compat_mode,
    )


def _compat_args(engine, scenario, scenario_seed, cgm_seed):
    """(engine, dtype, substeps, random_init_bg) of compat_mode, after
    checking its seeds."""
    if engine == "pallas":
        raise ValueError("compat_mode requires the XLA engine")
    if cgm_seed is None:
        raise ValueError("compat_mode requires an explicit cgm_seed")
    if scenario_seed is None and (scenario is None or isinstance(scenario, str)):
        raise ValueError(
            "compat_mode with a random scenario requires scenario_seed"
        )
    return "xla", np.float64, 4, False


def _names_and_start(patient_names, start_time):
    if patient_names is None:
        patient_names = tables.patient_names()
    if isinstance(patient_names, str):
        patient_names = [patient_names]
    if start_time is None:
        start_time = datetime(2018, 1, 1, 0, 0, 0)
    return list(patient_names), start_time


def _use_kernel(
    engine, interpret, scenario, controller, animate, substeps, dtype,
    reward_fun,
) -> bool:
    """The engine choice: True for the pallas kernel, False for XLA.
    'auto' takes the kernel where it is compiled for the device (a GPU)
    and the config is eligible; 'pallas' demands it and raises where it
    cannot run (ineligible config, or a CPU without interpret=True)."""
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError(f"engine must be 'auto', 'xla', or 'pallas'; got {engine!r}")
    if engine == "xla":
        return False
    blocker = _pallas_eligible(
        scenario, controller, animate, substeps, dtype, reward_fun
    )
    mode = kernel_mode(interpret)
    if engine == "pallas":
        if blocker is None and mode == XLA:
            blocker = (
                f"backend {jax.default_backend()!r} has no compiled kernel "
                "(pass interpret=True to run it in the Pallas interpreter)"
            )
        if blocker is not None:
            raise ValueError(
                f"engine='pallas' cannot run this config ({blocker}); "
                "use engine='xla' or 'auto'"
            )
        return True
    return blocker is None and mode != XLA


def simulate(
    sim_time: timedelta = timedelta(days=1),
    scenario: Optional[Union[str, MealSpec]] = None,
    scenario_seed: Optional[int] = None,
    controller=None,
    patient_names: Optional[Sequence[str]] = None,
    cgm_name: str = "Dexcom",
    cgm_seed: Optional[int] = None,
    insulin_pump_name: str = "Insulet",
    start_time: Optional[datetime] = None,
    save_path: Optional[str] = None,
    animate: bool = False,
    parallel: bool = True,  # accepted for API familiarity; always one program
    random_init_bg: bool = False,
    dtype=np.float32,
    substeps: int = 1,
    reward_fun: Callable = risk_diff_reward,
    engine: str = "auto",
    compat_mode: bool = False,
    interpret: bool = False,
):
    """Run a closed-loop cohort simulation and return the results frame.

    The programmatic analog of the reference's top-level ``simulate``
    (reference: simulation/user_interface.py:303-385): builds one env per
    patient, runs them all closed-loop for ``sim_time``, writes per-patient
    CSVs and the analysis report under ``save_path``, and returns the
    (patient, Time) multi-indexed DataFrame.  :func:`simulate_arrays` is
    the same run without the frame.

    ``scenario``: None → random daily meal plans (per-patient);
    'random' → same; a list of (time, grams) → CustomScenario for all
    patients (times are hours-since-start floats, timedeltas, or datetimes,
    reference: simulation/scenario.py:48-59).

    ``engine``: 'xla' — the general ``jit(vmap(scan))`` path (any
    controller/reward/scenario, bit-level seed reproducibility via
    threefry); 'pallas' — the single-kernel fast path (BB/PID, random or
    custom meal scenarios, any window-based reward_fun; a GPU, or the
    Pallas interpreter with ``interpret=True``; law-level seed
    reproducibility via the kernel's counter-based generator — raises
    ValueError if the config or device cannot run it); 'auto' — the
    kernel whenever it is eligible and compiled for the device (a GPU),
    else the XLA engine.  Auto never picks the interpreter.

    Both engines attach the per-step reward plane as
    ``df.attrs['reward']`` ([T, B]) — the reference frame schema has no
    reward column (env.py:169-180), so rewards ride alongside; on the
    pallas engine they are recomputed in XLA from the kernel's CGM planes
    with the exact ring-buffer window law
    (:func:`~simglucose_tpu.envs.functional.rewards_from_cgm`).

    ``compat_mode=True`` is the verification configuration: float64, rk45 at
    4 substeps/min, and MT19937-bit-exact CGM noise + meal scenario shared
    across the cohort exactly like the reference's simulate() (every patient
    gets the same cgm_seed sensor and a deepcopy of the same scenario,
    reference: simulation/user_interface.py:364-372).  Requires explicit
    ``cgm_seed`` (and ``scenario_seed`` for random scenarios); forces the
    XLA engine.  Output frames match a reference batch_sim run at the same
    seeds (tests/test_cohort_golden.py).
    """
    del parallel
    patient_names, start_time = _names_and_start(patient_names, start_time)
    B = len(patient_names)
    tic = time.time()
    if animate:
        if engine == "pallas":
            raise ValueError(
                "engine='pallas' cannot run this config (animate=True "
                "(incremental host rendering)); use engine='xla' or 'auto'"
            )
        if compat_mode:
            engine, dtype, substeps, random_init_bg = _compat_args(
                engine, scenario, scenario_seed, cgm_seed
            )
        df = _simulate_animated(
            *_xla_setup(
                sim_time, scenario, scenario_seed, controller,
                patient_names, cgm_name, cgm_seed, insulin_pump_name,
                start_time, random_init_bg, dtype, substeps, reward_fun,
                compat_mode,
            ),
            patient_names=patient_names,
            start_time=start_time,
        )
        used = "xla"
    else:
        arrays = simulate_arrays(
            sim_time=sim_time, scenario=scenario,
            scenario_seed=scenario_seed, controller=controller,
            patient_names=patient_names, cgm_name=cgm_name,
            cgm_seed=cgm_seed, insulin_pump_name=insulin_pump_name,
            start_time=start_time, random_init_bg=random_init_bg,
            dtype=dtype, substeps=substeps, reward_fun=reward_fun,
            engine=engine, compat_mode=compat_mode, interpret=interpret,
        )
        df = _frame(arrays, patient_names, start_time)
        used = arrays.engine
    logger.info(
        "Simulation of %d patients x %s took %.3f s (%s engine)",
        B, sim_time, time.time() - tic, used,
    )
    if save_path is not None:
        from simglucose_tpu.analysis.report import report

        os.makedirs(save_path, exist_ok=True)
        for name in patient_names:
            df.loc[name].to_csv(os.path.join(save_path, f"{name}.csv"))
        report(df, save_path=save_path)
    return df


def _simulate_animated(
    cfg,
    env_params,
    ctrl_init,
    ctrl_fn,
    ctrl_axes,
    reward_fun,
    keys,
    n_steps,
    start_min,
    patient_names,
    start_time,
):
    """Chunked rollout with incremental rendering (the reference's live
    animation, env.py:157-167): run ~1-hour compiled chunks, redraw the
    first few patients' Viewers after each chunk."""
    from simglucose_tpu.analysis.rendering import Viewer
    from simglucose_tpu.analysis.report import cohort_frame
    from simglucose_tpu.envs.rollout import (
        batch_reset,
        broadcast_ctrl_state,
        make_batch_continue_fn,
    )

    B = len(patient_names)
    state, reset_res = batch_reset(cfg, env_params, keys, start_min=start_min)
    if ctrl_axes is None:
        ctrl_state = broadcast_ctrl_state(ctrl_init, B)
    else:
        ctrl_state = ctrl_init
    chunk = max(60 // cfg.sample_time, 1)
    run = make_batch_continue_fn(cfg, ctrl_fn, chunk, reward_fun=reward_fun)

    viewers = [Viewer(start_time, n) for n in patient_names[:4]]
    pieces = []  # [T, B] StepResult chunks
    last = reset_res
    done_steps = 0
    while done_steps < n_steps:
        state, ctrl_state, last, traj = run(env_params, state, ctrl_state, last)
        n_take = min(chunk, n_steps - done_steps)
        traj = jax.tree.map(lambda a: np.asarray(a)[:n_take], traj)
        pieces.append(traj)
        done_steps += n_take
        df_sofar = cohort_frame(
            reset_res,
            jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *pieces),
            patient_names,
            start_time,
            cfg.sample_time,
        )
        for v in viewers:
            v.render(df_sofar.loc[v.patient_name])
    for v in viewers:
        v.close()
    full = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *pieces)
    df = cohort_frame(
        reset_res, full, patient_names, start_time, cfg.sample_time
    )
    df.attrs["reward"] = np.asarray(full.reward)  # [T, B]
    return df


class SimObj:
    """Familiar OO shim over one patient's simulation
    (reference: simulation/sim_engine.py:15-49)."""

    def __init__(
        self,
        patient_name: str,
        controller=None,
        sim_time: timedelta = timedelta(days=1),
        start_time: Optional[datetime] = None,
        scenario: Optional[MealSpec] = None,
        seed: int = 0,
        animate: bool = False,
        path: Optional[str] = None,
        **kwargs,
    ):
        self.patient_name = patient_name
        self.controller = controller
        self.sim_time = sim_time
        self.start_time = start_time or datetime(2018, 1, 1)
        self.scenario = scenario
        self.seed = seed
        self.animate = animate
        self.path = path
        self.kwargs = kwargs
        self._results = None

    def simulate(self):
        df = simulate(
            sim_time=self.sim_time,
            scenario=self.scenario,
            scenario_seed=self.seed,
            controller=self.controller,
            patient_names=[self.patient_name],
            start_time=self.start_time,
            animate=self.animate,
            **self.kwargs,
        )
        self._results = df.loc[self.patient_name]
        return self._results

    def results(self):
        if self._results is None:
            self.simulate()
        return self._results

    def save_results(self):
        if self.path is None:
            raise ValueError("SimObj.path not set")
        os.makedirs(self.path, exist_ok=True)
        self.results().to_csv(
            os.path.join(self.path, f"{self.patient_name}.csv")
        )


def sim(sim_object: SimObj):
    """Run one SimObj (reference: sim_engine.py:56-62)."""
    logger.info("Simulating %s", sim_object.patient_name)
    res = sim_object.simulate()
    if sim_object.path is not None:
        sim_object.save_results()
    return res


def batch_sim(sim_instances: Sequence[SimObj], parallel: bool = False):
    """Run a batch of SimObjs (reference: sim_engine.py:65-76).

    When every instance shares (controller type, sim_time, start, scenario,
    seed), the whole batch is fused into ONE compiled cohort program;
    otherwise they run sequentially (each still a compiled program).
    ``parallel`` is accepted for API familiarity — the fused path is
    always parallel.
    """
    tic = time.time()
    fuse_key = lambda o: (
        type(o.controller).__name__
        if not isinstance(o.controller, (str, type(None)))
        else o.controller,
        o.sim_time,
        o.start_time,
        None if o.scenario is None else tuple(map(tuple, o.scenario)),
        o.seed,
        tuple(sorted(o.kwargs.items())),
    )
    results = []
    if len(sim_instances) > 1 and len({fuse_key(o) for o in sim_instances}) == 1:
        o0 = sim_instances[0]
        df = simulate(
            sim_time=o0.sim_time,
            scenario=o0.scenario,
            scenario_seed=o0.seed,
            controller=o0.controller,
            patient_names=[o.patient_name for o in sim_instances],
            start_time=o0.start_time,
            **o0.kwargs,
        )
        for o in sim_instances:
            o._results = df.loc[o.patient_name]
            if o.path is not None:
                o.save_results()
            results.append(o._results)
    else:
        results = [sim(o) for o in sim_instances]
    logger.info("Simulation took %.3f sec.", time.time() - tic)
    return results
