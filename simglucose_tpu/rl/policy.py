"""Pure-JAX Gaussian MLP policy + value network for glucose control.

Obs featurization derives from the env's StepResult (the reference gym env
exposes CGM only, envs/simglucose_gym_env.py:78-85; the featurizer adds the
controller-visible info fields — meal and insulin — all of which the
reference also hands to controllers through the info dict, env.py:106-117).

Tensor-parallel ready: weights carry their hidden axis so the ('dp','tp')
mesh can shard them (see :func:`param_specs`); activations get sharding
constraints when a mesh is supplied.  XLA inserts the tp all-reduces.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

OBS_DIM = 7

ACTIVATIONS = ("tanh", "relu")

# Insulin-on-board decay time constant (minutes).  IOB is the
# exponentially-decayed sum of delivered insulin — the standard artificial-
# pancreas controller input that prevents insulin stacking (dosing again
# while the previous dose is still acting through the 30-60 min absorption
# lag).  The reference's RL env exposes CGM only
# (envs/simglucose_gym_env.py:78-85); IOB is derived purely from the
# policy's OWN past actions, so it adds no privileged information.
IOB_TAU_MIN = 100.0


def iob_step(iob, insulin, sample_time):
    """One control-step IOB update: decay by exp(-dt/tau), add the dose
    delivered this step (``insulin`` U/min x ``sample_time`` min = U).
    The ONE definition — the pallas kernel mirrors it with the identical
    static decay constant (a host-side ``math.exp``, so both paths multiply
    by the same f32-rounded scalar), pinned by the kernel-vs-env parity
    test."""
    decay = math.exp(-float(sample_time) / IOB_TAU_MIN)
    return iob * decay + insulin * float(sample_time)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PolicyParams:
    """Gaussian-MLP policy + value weights.

    ``act`` — the trunk activation ('tanh' or 'relu') — is STATIC pytree
    metadata, not a leaf: it travels with the params through jit/grad/optax
    and into checkpoints' tree structure, so a network can never be applied
    with the wrong nonlinearity.  The in-kernel actor
    (ops/pallas_rollout.py 'nn' controller) implements relu only;
    :func:`~simglucose_tpu.ops.pallas_rollout.pack_policy_weights` rejects
    anything else.

    ``decoder`` / ``action_scale`` / ``scale_by_basal`` — the action
    DECODER — are static metadata for the same reason: a network trained
    at one parameterization deployed at another runs silently as a
    different controller.  Two decoders exist:

    * ``'sigmoid'`` (default): rate = ``sigmoid(raw) * action_scale
      [* patient_basal]`` — an absolute-rate policy.
    * ``'residual_bb'``: rate = ``bb_cmd * exp(action_scale * tanh(raw))``
      where ``bb_cmd`` is the basal-bolus THERAPY command (per-patient
      basal + announced-meal/correction bolus from the Quest CR/CF table,
      reference basal_bolus_ctrller.py:34-80) — the policy multiplicatively
      modulates the reference's own strongest controller within
      ``[exp(-scale), exp(+scale)]``x.  A zero-output policy IS BB therapy,
      so training starts at the clinical baseline instead of discovering
      dosing from scratch, and bolus-sized doses are reachable (the
      absolute decoder's ceiling caps meal boluses —
      BASELINE.md round-5: BB clipped to 10x basal scores TIR 38% vs 86%).

    The trainers validate their config against the params
    (rl/ppo.make_train_step, rl/fused.make_fused_train_step) and the deploy
    form (rl/evaluate.policy_controller) reads the decoder from the params
    by default."""

    w1: jnp.ndarray  # [OBS_DIM, H]
    b1: jnp.ndarray  # [H]
    w2: jnp.ndarray  # [H, H]
    b2: jnp.ndarray  # [H]
    w_mu: jnp.ndarray  # [H, 1]
    b_mu: jnp.ndarray  # [1]
    log_std: jnp.ndarray  # [1]
    w_v: jnp.ndarray  # [H, 1]
    b_v: jnp.ndarray  # [1]
    act: str = dataclasses.field(default="tanh", metadata=dict(static=True))
    action_scale: float = dataclasses.field(
        default=0.2, metadata=dict(static=True)
    )
    scale_by_basal: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    decoder: str = dataclasses.field(
        default="sigmoid", metadata=dict(static=True)
    )


def param_specs(
    act: str = "tanh",
    action_scale: float = 0.2,
    scale_by_basal: bool = False,
    decoder: str = "sigmoid",
) -> PolicyParams:
    """PartitionSpecs sharding the hidden dimension over 'tp'.

    The static metadata kwargs must match the params the specs are applied
    to (a PolicyParams tree with different metadata is a different pytree
    structure)."""
    return PolicyParams(
        w1=P(None, "tp"),
        b1=P("tp"),
        w2=P("tp", None),
        b2=P(),
        w_mu=P("tp", None),
        b_mu=P(),
        log_std=P(),
        w_v=P("tp", None),
        b_v=P(),
        act=act,
        action_scale=action_scale,
        scale_by_basal=scale_by_basal,
        decoder=decoder,
    )


def init_policy(
    key: jax.Array,
    hidden: int = 128,
    dtype=jnp.float32,
    init_log_std: float = -0.5,
    init_mu_bias: float = 0.0,
    act: str = "tanh",
    action_scale: float = 0.2,
    scale_by_basal: bool = False,
    decoder: str = "sigmoid",
) -> PolicyParams:
    """``init_mu_bias`` shifts the initial action distribution: the emitted
    basal starts near ``sigmoid(init_mu_bias) * action_scale``.  The default
    0 starts at half the action range; a negative bias (e.g. -2.2 ->
    ~0.02 U/min at scale 0.2) starts from safe under-insulinization, which
    is the clinically sensible cold-start for training.

    ``act`` picks the trunk activation; ``decoder``/``action_scale``/
    ``scale_by_basal`` the action decoder; all are carried in the params
    as static metadata (see :class:`PolicyParams`).  Use 'relu' for
    networks destined for the pallas-fused actor.  For
    ``decoder='residual_bb'`` the default ``init_mu_bias=0`` makes the
    fresh policy EXACTLY basal-bolus therapy (``exp(scale*tanh(0)) = 1``).
    """
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {ACTIVATIONS}; got {act!r}")
    if decoder not in ("sigmoid", "residual_bb"):
        raise ValueError(
            f"decoder must be 'sigmoid' or 'residual_bb'; got {decoder!r}"
        )
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def he(k, shape):
        return jax.random.normal(k, shape, dtype) * jnp.sqrt(2.0 / shape[0])

    return PolicyParams(
        w1=he(k1, (OBS_DIM, hidden)),
        b1=jnp.zeros((hidden,), dtype),
        w2=he(k2, (hidden, hidden)),
        b2=jnp.zeros((hidden,), dtype),
        w_mu=he(k3, (hidden, 1)) * 0.01,
        b_mu=jnp.full((1,), init_mu_bias, dtype),
        log_std=jnp.full((1,), init_log_std, dtype),
        w_v=he(k4, (hidden, 1)),
        b_v=jnp.zeros((1,), dtype),
        act=act,
        action_scale=float(action_scale),
        scale_by_basal=bool(scale_by_basal),
        decoder=decoder,
    )


def check_action_decoder(
    params: "PolicyParams", action_scale: float, scale_by_basal: bool,
    where: str, decoder: str = "sigmoid",
) -> None:
    """Raise if a training/deploy config's action decoder disagrees with
    the decoder the params were built for (PolicyParams static metadata) —
    the same silent-mismatch class as the trunk-activation check in
    pack_policy_weights."""
    if (
        float(params.action_scale) != float(action_scale)
        or bool(params.scale_by_basal) != bool(scale_by_basal)
        or getattr(params, "decoder", "sigmoid") != decoder
    ):
        raise ValueError(
            f"{where}: action decoder mismatch — params carry "
            f"decoder={getattr(params, 'decoder', 'sigmoid')!r}, "
            f"action_scale={params.action_scale}, "
            f"scale_by_basal={params.scale_by_basal} but the config uses "
            f"decoder={decoder!r}, action_scale={action_scale}, "
            f"scale_by_basal={scale_by_basal}. "
            f"Build the params with init_policy(...) matching the "
            f"PPOConfig, or fix the config."
        )


def featurize_parts(cgm, insulin, cho, cgm_prev, iob, basal) -> jnp.ndarray:
    """(CGM, insulin, CHO, previous-sample CGM, insulin-on-board, patient
    basal) -> [..., OBS_DIM] normalized features — the ONE definition of the
    observation normalization (the pallas 'nn' kernel mirrors these
    constants in-kernel, ops/pallas_rollout.py, and its parity test pins
    them against this function).

    The seven features and why:

    * ``cgm/400`` and ``(cgm-140)/100`` — absolute level, two resolutions.
    * ``tanh(insulin/(3*basal))`` — last delivered rate in units of the
      patient's own basal (absolute U/min means 6x different therapy
      intensity across the cohort).  All features are bounded: insulin can
      reach the pump's 30 U/min ceiling while exploring, and an unbounded
      feature saturates the trunk (72% of units at |h|>0.99 in round-1
      diagnostics), killing the policy gradient.
    * ``tanh(cho/10)`` — the announced meal (g/min averaged over the step),
      the same signal the BB controller doses on
      (reference: basal_bolus_ctrller.py:42-56).
    * ``tanh((cgm - cgm_prev)/10)`` — CGM trend per sample interval: rising
      glucose is the early-meal signal a memoryless level-only policy
      cannot see until it is late.
    * ``tanh(iob/(120*basal))`` — insulin-on-board in units of ~2 h of the
      patient's basal (see :func:`iob_step`): dosing without IOB stacks
      boluses through the 30-60 min absorption lag straight into
      hypoglycemia.
    * ``tanh(20*basal)`` — patient identity (therapy intensity): cohort
      basals span 0.01-0.06 U/min, so one universal policy can personalize
      its strategy by size/sensitivity.
    """
    # basal is static per patient ([B] against [T, B] trajectory planes)
    cgm, insulin, cho, cgm_prev, iob, basal = jnp.broadcast_arrays(
        cgm, insulin, cho, cgm_prev, iob, basal
    )
    b = basal + 1e-8
    return jnp.stack(
        [
            cgm / 400.0,
            (cgm - 140.0) / 100.0,
            jnp.tanh(insulin / (3.0 * b)),
            jnp.tanh(cho / 10.0),
            jnp.tanh((cgm - cgm_prev) / 10.0),
            jnp.tanh(iob / (120.0 * b)),
            jnp.tanh(20.0 * basal),
        ],
        axis=-1,
    )


def featurize(result, basal, cgm_prev=None, iob=None) -> jnp.ndarray:
    """StepResult -> [..., OBS_DIM] features (see :func:`featurize_parts`).

    ``cgm_prev``/``iob`` default to the cold-start values (zero trend, zero
    insulin-on-board — exactly the episode-reset observation); stateful
    callers (the PPO rollouts, ``policy_controller``) thread the real
    values."""
    cgm = result.observation.CGM
    if cgm_prev is None:
        cgm_prev = cgm
    if iob is None:
        iob = jnp.zeros_like(cgm)
    return featurize_parts(
        cgm, result.insulin, result.CHO, cgm_prev, iob, basal
    )


def policy_apply(
    params: PolicyParams,
    obs: jnp.ndarray,
    mesh: Optional[Mesh] = None,
    compute_dtype=None,
):
    """Returns (mu, log_std, value) for obs [..., OBS_DIM].

    All matmuls carry ``preferred_element_type=float32`` so reduced-
    precision inputs still accumulate in f32, and precision HIGHEST: f32
    inputs are multiplied in full f32, never TF32 (a GPU's default for f32
    products), which matches the kernel's in-kernel policy
    (ops/pallas_rollout.py) and the CPU.
    ``compute_dtype=jnp.bfloat16`` runs the trunk in bf16: matmul inputs
    AND the materialized hidden activations are bf16 (f32 accumulation,
    f32 bias-add in the matmul epilogue, f32 heads/outputs); params and
    optimizer state stay f32 (see PPOConfig.learner_bf16).

    The trunk activation comes from ``params.act`` (static metadata — see
    :class:`PolicyParams`), so a checkpoint is always applied with the
    nonlinearity it was trained with; there is no way to run a tanh-trained
    network as relu or vice versa."""
    f = jnp.tanh if params.act == "tanh" else lambda x: jnp.maximum(x, 0.0)
    cast = (lambda x: x) if compute_dtype is None else (
        lambda x: x.astype(compute_dtype)
    )

    def cstr(x, spec):
        if mesh is not None and "tp" in mesh.axis_names:
            return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
        return x

    dot = lambda a, b: jnp.dot(
        cast(a), cast(b), preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    h = cast(
        f(
            cstr(
                dot(obs, params.w1) + params.b1,
                P("dp", "tp") if obs.ndim == 2 else P("tp"),
            )
        )
    )
    h = cast(f(dot(h, params.w2) + params.b2))
    # one [H, 2] head matmul instead of two [H, 1] ones: each output column
    # is an independent dot over the same K, so values are unchanged, but
    # the learner launches half the head kernels per minibatch
    w_head = jnp.concatenate([params.w_mu, params.w_v], axis=1)
    b_head = jnp.concatenate([params.b_mu, params.b_v])
    hv = dot(h, w_head) + b_head
    return hv[..., 0], params.log_std[0], hv[..., 1]


def gaussian_logprob(mu, log_std, x):
    z = (x - mu) * jnp.exp(-log_std)
    return -0.5 * z * z - log_std - 0.5 * jnp.log(2.0 * jnp.pi)


def sample_action(params: PolicyParams, obs, key, scale: float = 0.2, mesh=None):
    """Sample a basal rate (U/min): squash N(mu, std) through a sigmoid
    onto [0, scale].

    ``scale`` bounds exploration to an informative band: cohort basal rates
    are 0.01-0.06 U/min (u2ss*BW/6000), so the default 0.2 covers ~4x the
    strongest therapy while excluding the instantly-fatal region near the
    pump's 30 U/min ceiling (see PPOConfig.action_scale)."""
    mu, log_std, v = policy_apply(params, obs, mesh=mesh)
    eps = jax.random.normal(key, mu.shape, mu.dtype)
    raw = mu + jnp.exp(log_std) * eps
    logp = gaussian_logprob(mu, log_std, raw)
    basal = jax.nn.sigmoid(raw) * scale
    return basal, raw, logp, v
