"""Gymnasium adapter: drop-in RL API over the functional env.

Mirrors the reference's gym wrapper (reference: envs/simglucose_gym_env.py:18-85)
with the modern Gymnasium API, plus an on-device vectorized env that the
reference has no analog for.

Semantics parity with the reference wrapper:
  * scalar action = basal only, bolus = 0 (simglucose_gym_env.py:41-46)
  * hardware fixed to Dexcom CGM + Insulet pump (:24-25) unless overridden
  * every reset builds a brand-new episode with fresh start hour (0-23 on
    2018-01-01), fresh scenario, and random initial BG (:48-51, :66-68)
  * the seed chain seed2/3/4 = sha512 hash chain from a numpy RandomState
    (:58-73) is reproduced bit-for-bit via :mod:`simglucose_tpu.compat.seeding`
  * ``action_space = Box[0, pump.max_basal]``, ``observation_space =
    Box[0, inf)`` (:78-85)

Two episode-generation modes:
  * ``compat_mode=False`` (default): on-device `jax.random` everywhere —
    the fast, native path.
  * ``compat_mode=True``: CGM noise, meal scenario, and initial BG are
    pre-generated on host with MT19937 bit-exactness so episodes match the
    reference trace-for-trace at the same seed (the verification path).
"""
from __future__ import annotations

from datetime import datetime, timedelta
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

try:
    import gymnasium
    from gymnasium import spaces
except ImportError:  # pragma: no cover - gymnasium is available in CI
    gymnasium = None
    spaces = None

from simglucose_tpu import params as tables
from simglucose_tpu.analysis.risk import risk_diff_reward
from simglucose_tpu.compat.noise import reference_cgm_noise
from simglucose_tpu.compat.patient import reference_init_state
from simglucose_tpu.compat.scenario import reference_meal_seq
from simglucose_tpu.compat.seeding import gym_seed_chain, np_random
from simglucose_tpu.core.types import CtrlAction, EnvState, StepResult
from simglucose_tpu.envs.build import make_env
from simglucose_tpu.envs.functional import EnvConfig, EnvParams, env_reset, env_step
from simglucose_tpu.envs.rollout import autoreset_step, batch_reset

MealSpec = Sequence[Tuple[Union[float, timedelta, datetime], float]]


def parse_meal_times(
    scenario: MealSpec, start_time: Optional[datetime] = None
) -> tuple[np.ndarray, np.ndarray]:
    """Convert a reference-style custom scenario spec to (minutes, grams).

    Times may be float hours since episode start, ``timedelta`` since start,
    or absolute ``datetime`` (requires ``start_time``) — the same three forms
    the reference accepts (reference: simulation/scenario.py:48-59).
    """
    times, amounts = [], []
    for t, amt in scenario:
        if isinstance(t, datetime):
            if start_time is None:
                raise ValueError("datetime meal times require start_time")
            minutes = (t - start_time).total_seconds() / 60.0
        elif isinstance(t, timedelta):
            minutes = t.total_seconds() / 60.0
        else:
            minutes = float(t) * 60.0
        times.append(int(round(minutes)))
        amounts.append(float(amt))
    return np.asarray(times, np.int32), np.asarray(amounts)


def _wrap_reward(reward_fun, window_size: int):
    """Accept native (window, window_len) reward fns or reference-style
    single-argument fns over the BG-last-hour array
    (reference: simulation/env.py:100-102).  1-arg fns get exact
    variable-length history semantics via
    :func:`simglucose_tpu.envs.functional.wrap_reward_fn`."""
    if reward_fun is None:
        return risk_diff_reward
    from simglucose_tpu.envs.functional import wrap_reward_fn

    return wrap_reward_fn(reward_fun, window_size)


class T1DSimGymEnv(gymnasium.Env if gymnasium else object):
    """Single-env Gymnasium wrapper (reference: envs/simglucose_gym_env.py).

    The underlying step is one jit-compiled XLA program reused across
    episodes and instances with the same static config.
    """

    metadata = {"render_modes": ["human"]}
    SENSOR_HARDWARE = "Dexcom"
    INSULIN_PUMP_HARDWARE = "Insulet"

    def __init__(
        self,
        patient_name: Optional[str] = None,
        custom_scenario: Optional[MealSpec] = None,
        reward_fun: Optional[Callable] = None,
        seed: Optional[int] = None,
        sensor: Optional[str] = None,
        pump: Optional[str] = None,
        compat_mode: bool = False,
        horizon_days: float = 30,
        substeps: Optional[int] = None,
        dtype=None,
        render_mode: Optional[str] = None,
    ):
        if patient_name is None:
            # reference hard-codes this default (simglucose_gym_env.py:33-35)
            patient_name = "adolescent#001"
        self.patient_name = patient_name
        self.sensor_name = sensor or self.SENSOR_HARDWARE
        self.pump_name = pump or self.INSULIN_PUMP_HARDWARE
        self.compat_mode = compat_mode
        # fractional days allowed (e.g. horizon_days=0.5 -> 12 h episodes)
        self.horizon_minutes = int(float(horizon_days) * 1440)
        self.render_mode = render_mode
        self._viewer = None
        self._raw_reward_fun = reward_fun
        if substeps is None:
            substeps = 4 if compat_mode else 1
        if dtype is None:
            dtype = np.float64 if compat_mode else np.float32
        self._dtype = dtype
        self._substeps = substeps

        self._custom = (
            None
            if custom_scenario is None
            else parse_meal_times(custom_scenario, datetime(2018, 1, 1))
        )

        self.np_random_state, self._seed1 = np_random(seed)
        self._build_static()
        self._new_episode()

    # -- construction ------------------------------------------------------

    def _build_static(self):
        """Static config + jitted step/reset, shared across episodes."""
        st = tables.sensor_sample_time(self.sensor_name)
        if self.compat_mode:
            scenario_mode = "custom" if self._custom else "exogenous"
            noise_len = self.horizon_minutes // st + 4
        else:
            scenario_mode = "custom" if self._custom else "random"
        noise_seq = (
            np.zeros(noise_len, self._dtype) if self.compat_mode else None
        )
        meal_seq = (
            np.zeros(self.horizon_minutes + st, self._dtype)
            if (self.compat_mode and not self._custom)
            else None
        )
        custom_times, custom_amounts = self._custom or (None, None)
        self.cfg, self._params0 = make_env(
            self.patient_name,
            sensor=self.sensor_name,
            pump=self.pump_name,
            dtype=self._dtype,
            substeps=self._substeps,
            method="rk45" if self.compat_mode else "rk4",
            noise_seq=noise_seq,
            meal_seq=meal_seq,
            custom_times=custom_times,
            custom_amounts=custom_amounts,
            scenario_mode=scenario_mode,
            random_init_bg=not self.compat_mode,
        )

        reward = _wrap_reward(self._raw_reward_fun, self.cfg.window_size)
        cfg = self.cfg

        self._jit_reset = jax.jit(
            lambda params, key, start_min, init_state: env_reset(
                cfg, params, key, start_min=start_min, init_state=init_state
            ),
            static_argnums=(),
        )
        self._jit_reset_noinit = jax.jit(
            lambda params, key, start_min: env_reset(
                cfg, params, key, start_min=start_min
            )
        )
        self._jit_step = jax.jit(
            lambda params, state, action: env_step(
                cfg, params, state, action, reward_fun=reward
            )
        )

    def _new_episode(self):
        """Fresh episode randomness — the analog of the reference's
        brand-new-env-per-reset (simglucose_gym_env.py:48-51)."""
        seed2, seed3, seed4, hour = gym_seed_chain(self.np_random_state)
        self._seeds = (seed2, seed3, seed4)
        self.start_time = datetime(2018, 1, 1, hour, 0, 0)
        start_min = hour * 60
        key = jax.random.PRNGKey(
            (seed2 * 1_000_003 + seed3 * 1009 + seed4) % (2**31)
        )

        params = self._params0
        init_state = None
        if self.compat_mode:
            st = self.cfg.sample_time
            n_noise = self.horizon_minutes // st + 4
            noise = reference_cgm_noise(
                tables.sensor_record(self.sensor_name), seed2, n_noise
            ).astype(self._dtype)
            params = params._replace(noise_seq=jnp.asarray(noise))
            if self._custom is None:
                meals = reference_meal_seq(
                    seed3, self.start_time, self.horizon_minutes + st
                ).astype(self._dtype)
                params = params._replace(meal_seq=jnp.asarray(meals))
            x0 = np.asarray(params.patient.x0, np.float64)
            init_state = jnp.asarray(
                reference_init_state(x0, seed4), self._dtype
            )

        self._params = params
        state, res = self._jit_reset(params, key, start_min, init_state)
        self._state: EnvState = state
        self._last: StepResult = res

    # -- gymnasium API -----------------------------------------------------

    @property
    def action_space(self):
        ub = float(tables.pump_record(self.pump_name)["max_basal"])
        return spaces.Box(low=0.0, high=ub, shape=(1,), dtype=np.float32)

    @property
    def observation_space(self):
        return spaces.Box(low=0.0, high=np.inf, shape=(1,), dtype=np.float32)

    def _obs(self, res: StepResult) -> np.ndarray:
        return np.asarray([float(res.observation.CGM)], np.float32)

    def _info(self, res: StepResult) -> dict:
        """The reference's rich info dict (simulation/env.py:106-117)."""
        minutes = int(self._state.patient.t)
        return {
            "sample_time": self.cfg.sample_time,
            "patient_name": self.patient_name,
            "meal": float(res.CHO),
            "patient_state": np.asarray(self._state.patient.x),
            "time": self.start_time + timedelta(minutes=minutes),
            "bg": float(res.BG),
            "lbgi": float(res.LBGI),
            "hbgi": float(res.HBGI),
            "risk": float(res.risk),
        }

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self.np_random_state, self._seed1 = np_random(seed)
        self._new_episode()
        self._history = []
        res = self._last
        self._record(res)
        return self._obs(res), self._info(res)

    def step(self, action):
        basal = jnp.asarray(np.squeeze(np.asarray(action)), self._dtype)
        act = CtrlAction(basal=basal, bolus=jnp.zeros_like(basal))
        self._state, res = self._jit_step(self._params, self._state, act)
        self._last = res
        self._record(res)
        terminated = bool(res.done)
        # horizon_days bounds every episode (native and compat mode alike;
        # in compat mode it also bounds the pregenerated noise/meal arrays)
        truncated = bool(
            int(self._state.patient.t) + self.cfg.sample_time
            > self.horizon_minutes
        )
        return (
            self._obs(res),
            float(res.reward),
            terminated,
            truncated,
            self._info(res),
        )

    def seed(self, seed: Optional[int] = None):
        """Legacy gym 0.9.4 seeding contract (simglucose_gym_env.py:53-56):
        re-seeds AND rebuilds the episode; returns [seed1..seed4]."""
        self.np_random_state, seed1 = np_random(seed)
        self._new_episode()
        return [seed1, *self._seeds]

    # -- rendering / history ----------------------------------------------

    def _record(self, res: StepResult):
        if not hasattr(self, "_history"):
            self._history = []
        minutes = int(self._state.patient.t)
        self._history.append(
            {
                "Time": self.start_time + timedelta(minutes=minutes),
                "BG": float(res.BG),
                "CGM": float(res.CGM),
                "CHO": float(res.CHO),
                "insulin": float(res.insulin),
                "LBGI": float(res.LBGI),
                "HBGI": float(res.HBGI),
                "Risk": float(res.risk),
            }
        )

    def show_history(self):
        """Episode history as a DataFrame (reference: env.py:169-180)."""
        import pandas as pd

        df = pd.DataFrame(self._history)
        if len(df):
            df = df.set_index("Time")
        return df

    def render(self):
        if self.render_mode != "human":
            return
        from simglucose_tpu.analysis.rendering import Viewer

        if self._viewer is None:
            self._viewer = Viewer(self.start_time, self.patient_name)
        self._viewer.render(self.show_history())

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None


class T1DSimVectorEnv(gymnasium.vector.VectorEnv if gymnasium else object):
    """On-device vectorized env: B auto-resetting patients in ONE compiled
    XLA program per step — the on-device replacement for running B gym envs
    in OS processes (reference: sim_engine.py:65-76 via pathos).

    Episodes auto-reset on termination OR horizon truncation
    (``horizon_days``, parity with the single env) with fresh random start
    hour and initial BG.  Gymnasium SAME-STEP autoreset convention
    (declared via ``metadata['autoreset_mode']``): when env i ends, ``step``
    returns the NEW episode's reset observation for env i (the reference
    wrapper hands the agent the fresh episode's obs after done,
    simglucose_gym_env.py:48-51) and carries the terminal step in
    ``info["final_observation"][i]`` / ``info["final_info"][i]``.

    Every ``step()`` pays one host dispatch; use :meth:`step_n` to run N
    policy-driven steps in ONE compiled dispatch.
    """

    metadata = {"render_modes": []}

    def __init__(
        self,
        num_envs: int,
        patient_names: Optional[Sequence[str]] = None,
        reward_fun: Optional[Callable] = None,
        seed: int = 0,
        sensor: str = "Dexcom",
        pump: str = "Insulet",
        dtype=np.float32,
        substeps: int = 1,
        horizon_days: float = 10.0,
    ):
        from simglucose_tpu.envs.build import cohort_names

        if patient_names is None:
            patient_names = cohort_names(num_envs)
        if len(patient_names) != num_envs:
            raise ValueError(
                f"got {len(patient_names)} patient names for {num_envs} envs"
            )
        self.num_envs = num_envs
        self.patient_names = list(patient_names)
        self.cfg, self._params = make_env(
            self.patient_names,
            sensor=sensor,
            pump=pump,
            dtype=dtype,
            batch=True,
            substeps=substeps,
            random_init_bg=True,
        )
        self._dtype = dtype
        ub = float(tables.pump_record(pump)["max_basal"])
        self.single_action_space = spaces.Box(
            low=0.0, high=ub, shape=(1,), dtype=np.float32
        )
        self.single_observation_space = spaces.Box(
            low=0.0, high=np.inf, shape=(1,), dtype=np.float32
        )
        self.action_space = spaces.Box(
            low=0.0, high=ub, shape=(num_envs, 1), dtype=np.float32
        )
        self.observation_space = spaces.Box(
            low=0.0, high=np.inf, shape=(num_envs, 1), dtype=np.float32
        )
        if gymnasium is not None and hasattr(gymnasium.vector, "AutoresetMode"):
            # Gymnasium 1.x autoreset contract declaration
            self.metadata = dict(
                self.metadata,
                autoreset_mode=gymnasium.vector.AutoresetMode.SAME_STEP,
            )

        cfg = self.cfg
        self.horizon_steps = int(
            horizon_days * 24 * 60 // cfg.sample_time
        )
        reward = _wrap_reward(reward_fun, cfg.window_size)
        self._reward = reward
        hs = self.horizon_steps
        self._jit_step = jax.jit(
            lambda params, state, action: jax.vmap(
                lambda p, s, a: autoreset_step(
                    cfg, p, s, a, reward_fun=reward, horizon_steps=hs
                )
            )(params, state, action)
        )
        self._stepn_cache = {}
        self._seed = seed
        self._state = None

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        if seed is not None:
            self._seed = seed
        keys = jax.random.split(jax.random.PRNGKey(self._seed), self.num_envs)
        self._state, res = batch_reset(self.cfg, self._params, keys)
        # the reset observation is the SECOND reset-time sensor sample
        # (env.py:142), matching what step()'s carry exposes after autoreset
        self._last_obs = res.observation.CGM
        obs = np.asarray(res.observation.CGM, np.float32)[:, None]
        return obs, {"bg": np.asarray(res.BG)}

    def step(self, actions):
        basal = jnp.asarray(
            np.asarray(actions).reshape(self.num_envs), self._dtype
        )
        act = CtrlAction(basal=basal, bolus=jnp.zeros_like(basal))
        self._state, res, carry, trunc = self._jit_step(
            self._params, self._state, act
        )
        # carry = reset result for just-ended envs, terminal otherwise
        self._last_obs = carry.observation.CGM
        obs = np.asarray(carry.observation.CGM, np.float32)[:, None]
        done = np.asarray(res.done)
        trunc = np.asarray(trunc)
        info = {
            "bg": np.asarray(carry.BG),
            "meal": np.asarray(carry.CHO),
            "insulin": np.asarray(carry.insulin),
            "risk": np.asarray(carry.risk),
        }
        ended = done | trunc
        if ended.any():
            final_obs = np.full(self.num_envs, None, dtype=object)
            final_info = np.full(self.num_envs, None, dtype=object)
            term_obs = np.asarray(res.observation.CGM, np.float32)
            term_bg = np.asarray(res.BG)
            term_risk = np.asarray(res.risk)
            for i in np.nonzero(ended)[0]:
                final_obs[i] = np.asarray([term_obs[i]], np.float32)
                final_info[i] = {"bg": term_bg[i], "risk": term_risk[i]}
            info["final_observation"] = final_obs
            info["_final_observation"] = ended.copy()
            info["final_info"] = final_info
            info["_final_info"] = ended.copy()
        return (
            obs,
            np.asarray(res.reward),
            done,
            trunc,
            info,
        )

    def step_n(self, n: int, policy: Callable):
        """Run ``n`` policy-driven steps in ONE compiled dispatch.

        ``policy(obs)`` maps the [B, 1] CGM observation (a jnp array, traced)
        to [B, 1] (or [B]) basal actions — it runs INSIDE the jitted scan, so
        an external RL loop pays one host dispatch per ``n`` steps instead of
        per step (a dispatch costs far more than the compiled step
        itself).  Auto-reset/truncation semantics are
        identical to :meth:`step`.

        Returns ``(obs [n,B,1], rewards [n,B], terminated [n,B],
        truncated [n,B], infos)`` where ``infos`` carries per-step array
        planes (``bg``/``risk`` of the carried obs) plus
        ``final_observation``/``final_info`` planes [n, B] that are valid
        where ``terminated|truncated`` (the same data the per-step dict
        exposes, in array form).

        Compiled once per (n, policy-object) pair and cached (bounded,
        true LRU — a hit refreshes the entry's recency): pass the SAME
        callable each call — a fresh lambda
        per call recompiles the whole n-step scan, and any values the
        callable closes over are baked in as constants at first trace
        (jit a parameterized policy and close over device arrays, or
        re-create the env to pick up new weights).
        """
        key = (id(policy), int(n))
        fn = self._stepn_cache.pop(key, None)
        if fn is not None:
            # re-insert on hit: eviction below pops the LEAST recently
            # used entry, not merely the oldest-inserted
            self._stepn_cache[key] = fn
        if fn is None:
            # bound the cache: each entry pins a compiled n-step program
            # (and the policy closure); evict the oldest beyond 8
            while len(self._stepn_cache) >= 8:
                self._stepn_cache.pop(next(iter(self._stepn_cache)))
            cfg, hs, reward = self.cfg, self.horizon_steps, self._reward
            dtype = self._dtype

            def run(params, state, prev_cgm):
                def body(carry, _):
                    state, prev_cgm = carry
                    a = jnp.asarray(policy(prev_cgm[:, None]), dtype)
                    basal = a.reshape(-1)
                    act = CtrlAction(basal=basal, bolus=jnp.zeros_like(basal))
                    state, res, carry_res, trunc = jax.vmap(
                        lambda p, s, a_: autoreset_step(
                            cfg, p, s, a_, reward_fun=reward, horizon_steps=hs
                        )
                    )(params, state, act)
                    out = (
                        carry_res.observation.CGM,
                        res.reward,
                        res.done,
                        trunc,
                        carry_res.BG,
                        carry_res.risk,
                        res.observation.CGM,  # final_observation where ended
                        res.BG,
                        res.risk,
                    )
                    return (state, carry_res.observation.CGM), out

                (state, last_obs), outs = jax.lax.scan(
                    body, (state, prev_cgm), None, length=n
                )
                return jax.lax.optimization_barrier((state, last_obs, outs))

            fn = jax.jit(run, donate_argnums=(1,))
            self._stepn_cache[key] = fn

        self._state, self._last_obs, outs = fn(
            self._params, self._state, self._last_obs
        )
        cgm, reward, done, trunc, bg, risk, f_cgm, f_bg, f_risk = [
            np.asarray(o) for o in outs
        ]
        ended = done | trunc
        infos = {
            "bg": bg,
            "risk": risk,
            "final_observation": np.where(ended, f_cgm, np.nan),
            "_final_observation": ended,
            "final_info": {"bg": f_bg, "risk": f_risk},
            "_final_info": ended,
        }
        return cgm[:, :, None], reward, done, trunc, infos

    def close(self):
        pass


def register_envs():
    """Register Gymnasium ids (reference: simglucose/__init__.py:1-6 registers
    'simglucose-v0').  Safe to call repeatedly."""
    if gymnasium is None:  # pragma: no cover
        return
    from gymnasium.envs.registration import register, registry

    for env_id in ("simglucose-v0", "simglucose_tpu/T1DSim-v0"):
        if env_id not in registry:
            register(
                id=env_id,
                entry_point="simglucose_tpu.envs.gym_env:T1DSimGymEnv",
            )
