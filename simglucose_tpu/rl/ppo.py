"""On-device PPO actor-learner over sharded patient cohorts.

BASELINE.json configs 4-5: an on-device training loop where the actor rolls
out thousands of auto-resetting envs (patients sharded over the mesh's 'dp'
axis) and the learner updates a shared policy with PPO.  Everything — env
physics, action sampling, GAE, the clipped surrogate, and the optax update —
lives in ONE jitted program per iteration; under GSPMD the batch stays
sharded over 'dp', policy weights shard over 'tp', and XLA inserts the
gradient all-reduce between devices (the "sharded PPO learner via
collectives").
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from simglucose_tpu.core.types import CtrlAction, EnvState, StepResult
from simglucose_tpu.envs.functional import EnvConfig, EnvParams
from simglucose_tpu.envs.rollout import autoreset_step
from simglucose_tpu.rl.policy import (
    PolicyParams,
    featurize,
    gaussian_logprob,
    iob_step,
    policy_apply,
    sample_action,
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    rollout_steps: int = 64
    epochs: int = 2
    minibatches: int = 4
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 1e-3
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    max_basal: float = 30.0  # Insulet pump limit (params/pump_params.csv)
    # minibatch shuffling granularity (rows).  Shuffling contiguous blocks
    # of `shuffle_block` rows instead of single rows turns the minibatch
    # gather into a block copy while still mixing time steps and patients
    # across minibatches (a block is 1/16th of one time step's lanes at
    # B=8192).  Rounded down to a power-of-two divisor of the minibatch
    # size at trace time.
    shuffle_block: int = 512
    # reset-candidate / midnight-regen sampling cadence for the XLA rollout
    # (envs/rollout.py autoreset_step_with_candidate): 1 = exact per-step
    # resets; K > 1 amortizes the rare-path sampling over K-step chunks —
    # trajectory-exact for surviving lanes, candidate resets drawn up to K
    # steps early for dying ones (same law).  The fused pallas trainer has
    # its own regen_every analog.  rollout_steps must be divisible by K.
    reset_cadence: int = 1
    # upper bound of the policy's basal range (U/min): the squashed Gaussian
    # emits basal in [0, action_scale].  The pump ceiling (30 U/min) is ~500x
    # a therapeutic basal (~0.01-0.06, vpatient u2ss*BW/6000), so exploring
    # the full pump range gives every action the same outcome (fatal hypo)
    # and no gradient; 0.2 covers ~4x the strongest cohort basal while
    # keeping the explored band informative.
    action_scale: float = 0.2
    # scale the emitted basal by each patient's own therapy basal
    # (u2ss*BW/6000): action = sigmoid(raw) * action_scale * patient_basal,
    # so one policy output means the same therapy INTENSITY for a 25 kg
    # child and a 110 kg adult (cohort basals span ~6x).  The pallas-fused
    # trainer's analog is the kernel's nn_scale_by_basal config
    # (rl/fused.py wires this flag through); the deploy-side analog is
    # policy_controller(..., basal=...).
    scale_by_basal: bool = False
    # action decoder (rl/policy.py PolicyParams.decoder): 'sigmoid' — the
    # absolute-rate decoder above; 'residual_bb' — the policy modulates
    # basal-bolus therapy, rate = bb_cmd * exp(action_scale * tanh(raw)).
    # residual_bb trains on the pallas-fused path only (the kernel computes
    # the BB command from the Quest planes in-kernel); action_scale is the
    # log-range and scale_by_basal is ignored.
    decoder: str = "sigmoid"
    init_log_std: float = -0.5
    # mixed-precision learner: cast matmul inputs (activations + weights) to
    # bf16 in the PPO loss forward/backward — f32 accumulation,
    # f32 params/optimizer state (policy_apply compute_dtype).  ~2x the
    # learner matmul throughput; the policy ratio stays consistent because
    # logp_old and the minibatch logp are recomputed by the same bf16
    # forward in the fused trainer.  Off by default (CI trains f32).
    learner_bf16: bool = False
    # subtracted from the step reward when the episode terminates (BG<70 or
    # BG>350).  With auto-reset, termination respawns the patient at a
    # healthy BG, so under dense negative rewards a policy can "farm" the
    # low-risk post-reset steps by dying quickly; an explicit terminal
    # penalty removes that exploit.  0 preserves the env's raw reward.
    done_penalty: float = 0.0


class TrainState(NamedTuple):
    params: PolicyParams
    opt_state: optax.OptState
    env_state: EnvState
    prev_res: StepResult
    key: jax.Array
    # observation-memory carries for the trend / insulin-on-board features
    # (rl/policy.py featurize_parts): the CGM sample before prev_res's and
    # the decayed delivered-insulin sum.  None (the default) means the
    # cold-start values — zero trend, zero IOB, exactly the episode-reset
    # observation — so construction from a fresh batch_reset stays a
    # 5-field call.
    cgm_prev: Optional[jnp.ndarray] = None
    iob: Optional[jnp.ndarray] = None


class Transition(NamedTuple):
    obs: jnp.ndarray
    raw_action: jnp.ndarray
    logp: jnp.ndarray
    value: jnp.ndarray
    reward: jnp.ndarray
    done: jnp.ndarray


def make_optimizer(cfg: PPOConfig):
    # flatten: clip + adam run over ONE packed [P] vector instead of 9
    # small leaves — same math, ~1/9th the tiny-kernel launches per
    # minibatch (the learner is launch-bound, not FLOPs-bound: the whole
    # policy is ~5K params).
    # NOTE: flatten changes the opt_state pytree (adam mu/nu become single
    # [P] vectors), so optimizer states checkpointed before this change do
    # not restore against the new layout (restore_state raises a leaf
    # mismatch).  POLICY checkpoints (params only, e.g. the shipped
    # examples/checkpoints) are unaffected; to resume an old run, restore
    # against ``legacy_optimizer(cfg).init(params)`` and convert with
    # :func:`migrate_opt_state`.
    return optax.flatten(_base_optimizer(cfg))


def _base_optimizer(cfg: PPOConfig):
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm), optax.adam(cfg.lr)
    )


def legacy_optimizer(cfg: PPOConfig):
    """The pre-flatten optimizer layout (mu/nu as PolicyParams pytrees).
    Its ``.init(params)`` is the restore TEMPLATE for optimizer-state
    checkpoints saved before :func:`make_optimizer` gained
    ``optax.flatten``; pass the restored state to
    :func:`migrate_opt_state` to resume training with the current
    optimizer."""
    return _base_optimizer(cfg)


def migrate_opt_state(legacy_opt_state, params: PolicyParams, cfg: PPOConfig):
    """Convert a legacy (unflattened) optimizer state to the current
    flattened layout, preserving the adam step count and moments.

    Usage for a pre-flatten checkpoint::

        tmpl = (params_template, legacy_optimizer(cfg).init(params_template))
        params, old_opt = restore_state(path, tmpl)
        opt_state = migrate_opt_state(old_opt, params, cfg)

    The moment vectors are raveled in ``jax.flatten_util.ravel_pytree``
    order — exactly how ``optax.flatten`` lays them out."""
    from jax.flatten_util import ravel_pytree

    new_state = make_optimizer(cfg).init(params)
    old_adam = _find_adam_state(legacy_opt_state)
    new_adam = optax.ScaleByAdamState(
        count=old_adam.count,
        mu=ravel_pytree(old_adam.mu)[0],
        nu=ravel_pytree(old_adam.nu)[0],
    )
    return _replace_adam_state(new_state, new_adam)


def _rollout(
    cfg: PPOConfig,
    env_cfg: EnvConfig,
    env_params: EnvParams,
    params: PolicyParams,
    env_state: EnvState,
    prev_res: StepResult,
    cgm_prev: jnp.ndarray,
    iob: jnp.ndarray,
    patient_basal: jnp.ndarray,
    key: jax.Array,
    mesh: Optional[Mesh],
    reward_fun=None,
):
    """Collect rollout_steps transitions from the batched auto-reset env.

    ``cgm_prev``/``iob`` are the observation-memory carries behind the
    trend and insulin-on-board features (rl/policy.py featurize_parts);
    both follow the auto-reset semantics the pallas 'nn' kernel implements
    (zero trend and zero IOB on the post-reset observation)."""
    step_kwargs = {} if reward_fun is None else {"reward_fun": reward_fun}
    st = env_cfg.sample_time

    def make_body(step_env):
        def body(carry, _):
            env_state, prev, cgm_prev, iob, key = carry
            key, k_act = jax.random.split(key)
            obs = featurize(prev, patient_basal, cgm_prev=cgm_prev, iob=iob)
            basal, raw, logp, value = sample_action(
                params, obs, k_act, scale=cfg.action_scale, mesh=mesh
            )
            if cfg.scale_by_basal:
                basal = basal * patient_basal
            action = CtrlAction(basal=basal, bolus=jnp.zeros_like(basal))
            env_state, res, carry_res = step_env(env_state, action)
            reward = res.reward - cfg.done_penalty * res.done.astype(value.dtype)
            tr = Transition(
                obs=obs,
                raw_action=raw,
                logp=logp,
                value=value,
                reward=reward,
                done=res.done,
            )
            # next obs memory: trend baseline is the CGM just acted on; IOB
            # decays and adds the DELIVERED (post-pump-quantization) dose.  A
            # reset zeroes both (the new episode's obs has no history).
            done = res.done
            next_cgm_prev = jnp.where(
                done, carry_res.observation.CGM, prev.observation.CGM
            )
            next_iob = jnp.where(
                done, jnp.zeros_like(iob), iob_step(iob, res.insulin, st)
            )
            # carry the post-reset observation forward: the first action of
            # each new episode is computed from the new episode's CGM
            # (reference semantics, simglucose_gym_env.py:48-51)
            return (env_state, carry_res, next_cgm_prev, next_iob, key), tr

        return body

    init = (env_state, prev_res, cgm_prev, iob, key)
    K = cfg.reset_cadence
    if K <= 1:
        body = make_body(
            lambda s, a: jax.vmap(partial(autoreset_step, env_cfg, **step_kwargs))(
                env_params, s, a
            )
        )
        carry, traj = jax.lax.scan(body, init, None, length=cfg.rollout_steps)
    else:
        # cadenced rare-path sampling (see PPOConfig.reset_cadence and
        # envs/rollout.py make_batch_rollout_fn): candidates + midnight
        # regen hoisted to chunk boundaries
        from simglucose_tpu.envs.rollout import (
            autoreset_step_with_candidate,
            make_reset_candidates,
        )
        from simglucose_tpu.scenario.meal import scenario_regen_now

        def chunk(carry, _):
            env_state, prev, cgm_prev, iob, key = carry
            if env_cfg.scenario_mode == "random":
                dt = env_state.scenario.meal_times.dtype
                scen = jax.vmap(
                    lambda s, t: scenario_regen_now(s, t, dtype=dt)
                )(env_state.scenario, env_state.patient.t)
                env_state = env_state._replace(scenario=scen)
            cand, cand_res = jax.vmap(
                partial(make_reset_candidates, env_cfg)
            )(env_params, env_state)
            body = make_body(
                lambda s, a: jax.vmap(
                    partial(autoreset_step_with_candidate, env_cfg, **step_kwargs)
                )(env_params, s, a, cand, cand_res)
            )
            carry, traj = jax.lax.scan(
                body, (env_state, prev, cgm_prev, iob, key), None, length=K
            )
            return carry, traj

        carry, traj = jax.lax.scan(
            chunk, init, None, length=cfg.rollout_steps // K
        )
        traj = jax.tree.map(
            lambda a: a.reshape((cfg.rollout_steps,) + a.shape[2:]), traj
        )
    env_state, last_res, cgm_prev, iob, key = carry
    return env_state, last_res, cgm_prev, iob, key, traj


def _gae(cfg: PPOConfig, traj: Transition, last_value: jnp.ndarray):
    """Generalized advantage estimation over the [T, B] rollout.

    The backward recurrence ``adv_t = delta_t + (gamma*lam*nonterm_t) *
    adv_{t+1}`` is a linear first-order recurrence, so it runs as a
    parallel ``associative_scan`` over the time axis — log2(T) rounds of
    full [T, B] elementwise work instead of T sequential [B]-sized kernel
    launches."""
    nonterm = 1.0 - traj.done.astype(traj.value.dtype)
    v_next = jnp.concatenate([traj.value[1:], last_value[None]], axis=0)
    delta = traj.reward + cfg.gamma * v_next * nonterm - traj.value
    coef = cfg.gamma * cfg.lam * nonterm

    # composing f_t(x) = d_t + c_t * x.  reverse=True reduces suffixes with
    # the LATER element on the left, so combine(a, b) must express
    # "apply a (the later suffix), then b": b ∘ a = (c_b c_a, d_b + c_b d_a)
    def combine(a, b):
        ca, da = a
        cb, db = b
        return ca * cb, db + cb * da

    _, advs = jax.lax.associative_scan(combine, (coef, delta), reverse=True)
    returns = advs + traj.value
    return advs, returns


def _ppo_loss(
    cfg: PPOConfig,
    params: PolicyParams,
    batch,
    mesh: Optional[Mesh],
):
    obs, raw, logp_old, adv, ret = batch
    mu, log_std, value = policy_apply(
        params, obs, mesh=mesh,
        compute_dtype=jnp.bfloat16 if cfg.learner_bf16 else None,
    )
    logp = gaussian_logprob(mu, log_std, raw)
    ratio = jnp.exp(logp - logp_old)
    adv_n = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg1 = ratio * adv_n
    pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -jnp.minimum(pg1, pg2).mean()
    v_loss = 0.5 * jnp.square(value - ret).mean()
    entropy = (log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e)).mean()
    loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    return loss, (pg_loss, v_loss, entropy)


def _find_adam_state(opt_state) -> optax.ScaleByAdamState:
    """Locate the ScaleByAdamState inside make_optimizer's (flattened)
    state tree — under optax.flatten the mu/nu leaves are single [P]
    vectors in jax.flatten_util.ravel_pytree order."""
    found = []

    def rec(s):
        if isinstance(s, optax.ScaleByAdamState):
            found.append(s)
        elif isinstance(s, (tuple, list)):
            for x in s:
                rec(x)

    rec(opt_state)
    if len(found) != 1:  # pragma: no cover - make_optimizer always has one
        raise ValueError(f"expected one ScaleByAdamState, found {len(found)}")
    return found[0]


def _replace_adam_state(opt_state, new):
    if isinstance(opt_state, optax.ScaleByAdamState):
        return new
    if isinstance(opt_state, tuple) and hasattr(opt_state, "_fields"):
        return type(opt_state)(
            *(_replace_adam_state(x, new) for x in opt_state)
        )
    if isinstance(opt_state, tuple):
        return tuple(_replace_adam_state(x, new) for x in opt_state)
    return opt_state


def _shuffle_blocking(cfg: PPOConfig, N: int):
    """(block_rows, n_blocks, mb_size): the block-granular shuffle layout
    for an N-row buffer (see PPOConfig.shuffle_block) — one definition for
    every learner path."""
    mb_size = N // cfg.minibatches
    # keep >=256 blocks so small (CI-scale) runs still mix well; at bench
    # scale (N=524288) this is the full 512-row block size
    bs = max(1, min(cfg.shuffle_block, N // 256))
    while mb_size % bs:
        bs //= 2
    return bs, N // bs, mb_size


def _update(
    cfg: PPOConfig,
    opt,
    params: PolicyParams,
    opt_state,
    traj: Transition,
    advs: jnp.ndarray,
    rets: jnp.ndarray,
    key: jax.Array,
    mesh: Optional[Mesh],
):
    """The PPO learner: epochs x minibatches of clipped-surrogate updates
    over a [T, B] rollout.  Shared by the XLA-rollout trainer
    (:func:`make_train_step`) and the pallas-fused trainer (rl/fused.py).

    Minibatches are drawn by BLOCK-granular shuffling of one packed buffer
    (see PPOConfig.shuffle_block): permuting contiguous blocks of rows is a
    block copy that still mixes time steps and patients across
    minibatches.  Under a mesh the batch stays sharded and GSPMD inserts
    the gradient all-reduce."""
    T, B = traj.reward.shape
    N = T * B
    obs_dim = traj.obs.shape[-1]
    bs, n_blocks, mb_size = _shuffle_blocking(cfg, N)
    packed = jnp.concatenate(
        [
            traj.obs.reshape(N, obs_dim),
            traj.raw_action.reshape(N, 1),
            traj.logp.reshape(N, 1),
            advs.reshape(N, 1),
            rets.reshape(N, 1),
        ],
        axis=1,
    )

    def epoch(carry, _):
        params, opt_state, key = carry
        key, k_perm = jax.random.split(key)
        perm = jax.random.permutation(k_perm, n_blocks)
        shuffled = packed.reshape(n_blocks, bs, obs_dim + 4)[perm]
        shuffled = shuffled.reshape(N, obs_dim + 4)

        def minibatch(carry, i):
            params, opt_state = carry
            rows = jax.lax.dynamic_slice_in_dim(shuffled, i * mb_size, mb_size)
            mb = (
                rows[:, :obs_dim],
                rows[:, obs_dim],
                rows[:, obs_dim + 1],
                rows[:, obs_dim + 2],
                rows[:, obs_dim + 3],
            )
            grads, aux = jax.grad(
                lambda p: _ppo_loss(cfg, p, mb, mesh), has_aux=True
            )(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), aux

        (params, opt_state), aux = jax.lax.scan(
            minibatch, (params, opt_state), jnp.arange(cfg.minibatches)
        )
        return (params, opt_state, key), aux

    (params, opt_state, key), aux = jax.lax.scan(
        epoch, (params, opt_state, key), None, length=cfg.epochs
    )
    return params, opt_state, key, aux


def make_train_step(
    cfg: PPOConfig,
    env_cfg: EnvConfig,
    mesh: Optional[Mesh] = None,
    reward_fun=None,
):
    """Build the jitted PPO iteration: rollout + GAE + epochs of minibatch
    updates.  ``env_params`` is a jit argument so it can carry shardings.

    ``reward_fun`` overrides the env's default risk-diff reward for
    training (the reference's pluggable ``reward_fun`` kwarg,
    reference: envs/simglucose_gym_env.py:27, simulation/env.py:100-102).
    Reference-style 1-arg rewards over the BG-last-hour history are
    adapted via :func:`~simglucose_tpu.envs.functional.wrap_reward_fn`,
    exactly like the gym adapters and ``simulate()``."""
    if reward_fun is not None:
        from simglucose_tpu.envs.functional import wrap_reward_fn

        reward_fun = wrap_reward_fn(reward_fun, env_cfg.window_size)
    if cfg.decoder != "sigmoid":
        raise ValueError(
            "the XLA-rollout trainer implements the 'sigmoid' decoder "
            "only; decoder='residual_bb' trains on the pallas-fused path "
            "(rl/fused.make_fused_train_step — the kernel computes the BB "
            "command in-kernel)"
        )
    if cfg.reset_cadence > 1:
        if cfg.rollout_steps % cfg.reset_cadence:
            raise ValueError(
                f"rollout_steps={cfg.rollout_steps} not divisible by "
                f"reset_cadence={cfg.reset_cadence}"
            )
        if cfg.reset_cadence * env_cfg.sample_time >= 300:
            raise ValueError(
                "reset_cadence*sample_time must stay inside the 5h "
                "post-midnight meal-free window (envs/rollout.py "
                "make_batch_rollout_fn)"
            )
    opt = make_optimizer(cfg)

    def train_step(env_params: EnvParams, ts: TrainState):
        from simglucose_tpu.models.uva_padova import basal_rate
        from simglucose_tpu.rl.policy import check_action_decoder

        check_action_decoder(
            ts.params, cfg.action_scale, cfg.scale_by_basal, "make_train_step"
        )
        patient_basal = basal_rate(env_params.patient)
        cgm0 = ts.prev_res.observation.CGM
        # None carries = the cold start (zero trend, zero IOB — exactly the
        # episode-reset observation, see TrainState)
        cgm_prev = cgm0 if ts.cgm_prev is None else ts.cgm_prev
        iob = jnp.zeros_like(cgm0) if ts.iob is None else ts.iob
        env_state, last_res, cgm_prev, iob, key, traj = _rollout(
            cfg, env_cfg, env_params, ts.params, ts.env_state, ts.prev_res,
            cgm_prev, iob, patient_basal, ts.key, mesh,
            reward_fun=reward_fun,
        )
        _, _, last_value = policy_apply(
            ts.params,
            featurize(last_res, patient_basal, cgm_prev=cgm_prev, iob=iob),
            mesh=mesh,
        )
        advs, rets = _gae(cfg, traj, last_value)
        params, opt_state, key, aux = _update(
            cfg, opt, ts.params, ts.opt_state, traj, advs, rets, key, mesh
        )
        metrics = {
            "reward_mean": traj.reward.mean(),
            "done_frac": traj.done.mean(),
            "pg_loss": aux[0].mean(),
            "v_loss": aux[1].mean(),
            "entropy": aux[2].mean(),
        }
        new_ts = TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            prev_res=last_res,
            key=key,
            cgm_prev=cgm_prev,
            iob=iob,
        )
        return new_ts, metrics

    return train_step
