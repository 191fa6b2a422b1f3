"""Pallas-fused PPO: the actor rollout (env physics + policy MLP + action
sampling) runs as ONE rollout kernel; the learner stays in XLA.

The XLA-scan rollout of :func:`simglucose_tpu.rl.ppo.make_train_step` runs
each env step as many small fusions; the kernel keeps the closed loop in
registers (ops/pallas_rollout.py).  This module routes PPO's rollout
through the kernel's 'nn' controller: the policy trunk runs inside the
kernel, and the kernel emits — besides the usual trajectory planes — the
raw pre-squash actions and the controller's observation inputs
(octrl/oins/ocho/oprev/oiob).  The learner reconstructs ``featurize()``
from those planes and recomputes log-probs and values in one batched XLA
forward pass, then runs the exact same ``_update`` (GAE + epochs of
clipped-surrogate minibatches) as the XLA-rollout trainer.

Episode state persists ACROSS training iterations (the kernel's
``persistent_state`` mode streams the full simulator state in/out), so
episodes are not truncated at rollout_steps — same semantics as the XLA
trainer's env-state carry.

This is BASELINE config 4 (on-device actor-learner over 8192 patients) at
kernel speed; the reference analog is rllab DDPG training over the gym env
(reference: examples/run_rllab.py:1-43, tests/test_rllab.py:13-52).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from simglucose_tpu.ops.pallas_rollout import (
    NS_F,
    NS_I,
    PallasRolloutConfig,
    config_for_sensor,
    make_pallas_rollout,
    make_sharded_pallas_rollout,
    pack_policy_weights,
    packed_basal,
)
from simglucose_tpu.rl.policy import (
    PolicyParams,
    featurize_parts,
    gaussian_logprob,
    policy_apply,
)
from simglucose_tpu.rl.ppo import PPOConfig, Transition, _gae, _update, \
    make_optimizer


class FusedTrainState(NamedTuple):
    params: PolicyParams
    opt_state: optax.OptState
    state_f: jnp.ndarray  # kernel simulator state, [NS_F, B] f32
    state_i: jnp.ndarray  # [NS_I, B] i32
    init: jnp.ndarray  # i32 scalar: 1 before the first rollout
    key: jax.Array


def init_fused_state(
    params: PolicyParams,
    opt_state,
    batch: int,
    key: jax.Array,
    mesh=None,
    axis: str = "dp",
) -> FusedTrainState:
    ts = FusedTrainState(
        params=params,
        opt_state=opt_state,
        state_f=jnp.zeros((NS_F, batch), jnp.float32),
        state_i=jnp.zeros((NS_I, batch), jnp.int32),
        init=jnp.int32(1),
        key=key,
    )
    if mesh is None:
        return ts
    # every leaf placed as the train step returns it (state planes over
    # the batch axis, the rest replicated), so the second call reuses the
    # first call's compilation instead of recompiling for new shardings
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard = NamedSharding(mesh, P(None, axis))
    rep = NamedSharding(mesh, P())
    return jax.device_put(ts, FusedTrainState(
        params=rep, opt_state=rep, state_f=shard, state_i=shard, init=rep,
        key=rep,
    ))


def _features(octrl, oins, ocho, oprev, oiob, basal):
    """featurize() from the kernel's observation planes (``basal`` [B] is
    static per patient and broadcasts over the time axis)."""
    return featurize_parts(octrl, oins, ocho, oprev, oiob, basal)


def make_fused_train_step(
    cfg: PPOConfig,
    batch: int,
    sensor: str = "Dexcom",
    hidden: int = 64,
    interpret: bool = False,
    pallas_overrides: Optional[dict] = None,
    mesh=None,
    axis: str = "dp",
    reward_kind: str = "risk_diff",
    continuing: bool = False,
    reward_fn=None,
):
    """Build the fused PPO iteration: pallas actor + XLA learner.

    Returns ``train_step(packed_params, ts) -> (ts', metrics)`` where
    ``packed_params`` comes from :func:`ops.pallas_rollout.pack_params` and
    ``ts`` is a :class:`FusedTrainState` (see :func:`init_fused_state`).
    The policy MUST carry the relu trunk (``init_policy(..., act='relu')``)
    with width ``hidden`` — the kernel runs that exact network, and
    ``pack_policy_weights`` rejects params whose static ``act`` metadata
    says otherwise (a tanh-trained checkpoint cannot silently run as relu).

    With ``mesh``, the kernel fans out one-per-device over the mesh's
    ``axis`` (patients sharded, weights replicated) and the learner's
    gradient all-reduce over the sharded minibatches is inserted by GSPMD —
    the multi-chip training configuration (BASELINE config 5).

    ``continuing=True`` trains the CONTINUING-task objective: auto-reset is
    off (a BG excursion is not an exit — the patient stays in the bad state
    and keeps collecting its reward, exactly like the fixed-horizon
    clinical evaluation protocol, reference sim_engine.py:29-39), and GAE
    sees no terminals.  This closes the train/eval mismatch that makes
    episodic auto-reset training exploitable: with dense negative rewards,
    dying respawns the patient at a healthy BG, so a policy can farm resets
    (measured: overdose -> 92% hypo time while the TRAIN reward improves).
    Thread fresh episodes periodically by setting ``ts.init = 1`` between
    dispatch blocks (tools/train_ppo_cohort.py re-inits every ~25 simulated
    hours).

    ``reward_fn(traj) -> [T, B] reward`` recomputes the training reward in
    XLA from the kernel's trajectory planes (CGM/BG/CHO/insulin/done),
    overriding the kernel's built-in ``reward_kind`` — arbitrary shaped
    training objectives (e.g. hypo-weighted risk) without kernel changes.
    The reference's pluggable ``reward_fun`` (simulation/env.py:100-102)
    at trainer scope; costs one fused elementwise pass over [T, B].
    """
    over = dict(
        controller="nn",
        nn_hidden=hidden,
        nn_action_scale=cfg.action_scale,
        nn_scale_by_basal=cfg.scale_by_basal,
        nn_decoder=cfg.decoder,
        n_steps=cfg.rollout_steps,
        persistent_state=True,
        reward_kind=reward_kind,
        autoreset=not continuing,
    )
    over.update(pallas_overrides or {})
    pcfg: PallasRolloutConfig = config_for_sensor(sensor, **over)
    if mesh is None:
        run = make_pallas_rollout(pcfg, batch, interpret=interpret)
    else:
        run = make_sharded_pallas_rollout(
            pcfg, batch, mesh, axis=axis, interpret=interpret
        )
    opt = make_optimizer(cfg)

    def train_step(packed_params: jnp.ndarray, ts: FusedTrainState):
        from simglucose_tpu.rl.policy import check_action_decoder

        check_action_decoder(
            ts.params, cfg.action_scale, cfg.scale_by_basal,
            "make_fused_train_step", decoder=cfg.decoder,
        )
        key, k_seed = jax.random.split(ts.key)
        seed = jax.random.randint(k_seed, (), 0, 2**31 - 1, jnp.int32)
        traj = run(
            packed_params,
            seed,
            weights=pack_policy_weights(ts.params),
            state=(ts.state_f, ts.state_i),
            init=ts.init,
        )
        # recompute logp/value at the rollout params in one batched forward
        basal = packed_basal(packed_params)  # [B], static per patient
        obs = _features(
            traj["octrl"], traj["oins"], traj["ocho"], traj["oprev"],
            traj["oiob"], basal,
        )  # [T, B, OBS_DIM]
        # the recompute and the minibatch loss forward share one
        # compute_dtype so the epoch-0 ratio at unchanged params is exactly 1
        cdt = jnp.bfloat16 if cfg.learner_bf16 else None
        mu, log_std, value = policy_apply(ts.params, obs, compute_dtype=cdt)
        logp = gaussian_logprob(mu, log_std, traj["raw"])
        tail_obs = _features(
            traj["tail_octrl"], traj["tail_oins"], traj["tail_ocho"],
            traj["tail_oprev"], traj["tail_oiob"], basal,
        )
        _, _, last_value = policy_apply(ts.params, tail_obs, compute_dtype=cdt)

        done = traj["done"]
        base_reward = (
            traj["reward"] if reward_fn is None else reward_fn(traj)
        )
        reward = base_reward - cfg.done_penalty * done.astype(value.dtype)
        # continuing task: BG excursions are not value-function terminals —
        # the state persists and its (bad) future rewards are the signal
        gae_done = jnp.zeros_like(done) if continuing else done
        tr = Transition(
            obs=obs,
            raw_action=traj["raw"],
            logp=logp,
            value=value,
            reward=reward,
            done=gae_done,
        )
        advs, rets = _gae(cfg, tr, last_value)
        params, opt_state, key, aux = _update(
            cfg, opt, ts.params, ts.opt_state, tr, advs, rets, key,
            mesh=mesh,
        )
        metrics = {
            "reward_mean": reward.mean(),
            "done_frac": done.mean(),
            "pg_loss": aux[0].mean(),
            "v_loss": aux[1].mean(),
            "entropy": aux[2].mean(),
        }
        # outputs that feed back into a donated next call must come from
        # distinct buffers — see envs/rollout.py (the f(donate(a), a)
        # CSE-aliasing hazard)
        state_f, state_i = jax.lax.optimization_barrier(
            (traj["state_f"], traj["state_i"])
        )
        new_ts = FusedTrainState(
            params=params,
            opt_state=opt_state,
            state_f=state_f,
            state_i=state_i,
            init=jnp.int32(0),
            key=key,
        )
        return new_ts, metrics

    return train_step


def make_fused_train_loop(
    cfg: PPOConfig, batch: int, iters_per_call: int, **kwargs
):
    """``lax.scan`` over ``iters_per_call`` fused train steps in ONE jitted
    program: host dispatch happens once per call instead of once per
    iteration.  Returns
    ``loop(packed_params, ts) -> (ts', metrics)`` with metrics stacked
    [iters_per_call]."""
    step = make_fused_train_step(cfg, batch, **kwargs)

    def loop(packed_params, ts: FusedTrainState):
        def body(carry, _):
            return step(packed_params, carry)

        return jax.lax.scan(body, ts, None, length=iters_per_call)

    return loop
