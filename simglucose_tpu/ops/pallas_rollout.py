"""Pallas fast path: the whole closed-loop rollout as one GPU kernel.

The XLA scan path runs every env step as ~40 small fusions (scenario, three
ODE minutes, noise, risk, reset-merge); each one round-trips the ~70 state
words per patient through device memory and is its own launch inside the
rollout's ``while`` loop.  This kernel keeps the full simulator state in
registers for the whole horizon: one program per block of ``block``
patients, an in-kernel ``fori_loop`` over env steps with the state as the
loop carry, and one coalesced store per trajectory plane per step.  The
physics is the same :func:`simglucose_tpu.models.uva_padova.model_rhs_parts`
the env path uses, on [block] vectors (one patient per lane).

The kernel is written for Pallas' Triton route (``backend="triton"``); on
the CPU it runs under ``interpret=True`` for the tests.

Scope (the high-throughput cohort-simulation configuration — the analog of
the reference's batch_sim use case, sim_engine.py:65-76):
  * rk4, substeps=1, f32, static sensor sample_time
  * native CGM noise law (AR(1) at the 15-min lattice -> Johnson-SU ->
    Catmull-Rom), driven by an in-kernel counter-based generator
  * native random daily meal scenario law (same distributions as
    scenario/meal.py, reference scenario_gen.py:33-60)
  * gym-style auto-reset with random start hour + random initial BG
  * built-in controllers: PID (gains as static floats), basal-bolus therapy
    (per-patient Quest CR/CF planes), constant basal, or the Gaussian MLP
    policy of rl/policy.py ('nn')
  * reward = risk_diff (reference env.py:27-33) or neg_risk

For custom controllers/rewards/sensors use the XLA path; both paths share
the same physics and parameter tables.  Statistical equivalence between the
two paths is asserted in tests/test_pallas_rollout.py; the deterministic
(no-noise/no-meal/no-reset) configuration must match env_step to f32
rounding.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from simglucose_tpu.core.types import PatientParams
from simglucose_tpu.models.uva_padova import EAT_RATE, model_rhs_parts

MDL_SAMPLE_TIME = 15  # noise lattice spacing, min (noise_gen.py:17)
MINUTES_PER_DAY = 1440
_LOG_2PI = math.log(2.0 * math.pi)
# smallest program: 16 patients (a warp is 32 threads)
MIN_BLOCK = 16

# Meal-slot law (scenario/meal.py, reference scenario_gen.py:36-44)
_MEAL_PROB = (0.95, 0.3, 0.95, 0.3, 0.95, 0.3)
_TIME_LB = tuple(x * 60.0 for x in (5, 9, 10, 14, 16, 20))
_TIME_UB = tuple(x * 60.0 for x in (9, 10, 14, 16, 20, 23))
_TIME_MU = tuple(x * 60.0 for x in (7, 9.5, 12, 15, 18, 21.5))
_TIME_SIGMA = (60.0, 30.0, 60.0, 30.0, 60.0, 30.0)
_AMOUNT_MU = (45.0, 10.0, 70.0, 10.0, 80.0, 10.0)
_AMOUNT_SIGMA = (10.0, 5.0, 10.0, 5.0, 10.0, 5.0)

# Order of the packed per-patient parameter planes fed to the kernel:
# the 34 non-x0 PatientParams fields, then x0_1..x0_13, then
# (basal, CR, CF) — see pack_params().
_PARAM_FIELDS = [f for f in PatientParams._fields if f != "x0"]
NP_PLANES = len(_PARAM_FIELDS) + 13 + 3

# Simulator state planes ([NS_F, B] f32 + [NS_I, B] i32) — the persistent
# state a caller threads between calls.  Names, in plane order:
#   x0..x12 ODE states; planned/last_CHO/eating/last_Qsto/foodtaken the
#   eating state machine; last_CGM (ZOH value between samples), e (AR(1)
#   state), lat0..3 (noise lattice); mt*/ma* the day's meal plan;
#   pid_integ/pid_prev; prev_risk (risk of the previous CGM, for
#   risk_diff); prev_cho (the previous step's averaged CHO — the BB
#   controller's meal announcement); ctrl_prev (the observation the
#   controller acts on — equals the previous CGM except at episode start,
#   where the env's reset draws TWO noise pops, env.py:126,142); c* the
#   cached auto-reset draw (refreshed every regen_every steps); ins_prev
#   (previous delivered insulin), ctrl_pprev (observation before
#   ctrl_prev, the 'nn' trend feature), iob (insulin on board).
_F_NAMES = (
    tuple(f"x{i}" for i in range(13))
    + ("planned", "last_CHO", "eating", "last_Qsto", "foodtaken",
       "last_CGM", "e", "lat0", "lat1", "lat2", "lat3")
    + tuple(f"mt{s}" for s in range(6))
    + tuple(f"ma{s}" for s in range(6))
    + ("pid_integ", "pid_prev", "prev_risk", "prev_cho", "ctrl_prev")
    + tuple(f"cx{i}" for i in range(13))
    + ("c_e", "clat0", "clat1", "clat2", "clat3", "c_cgm0", "c_risk0",
       "ins_prev", "ctrl_pprev", "iob")
)
#   t_min (episode minutes), start_min, day, seg, lat_next (next lattice
#   index), n_samp (CGM samples drawn), c_start (cached reset start_min)
_I_NAMES = ("t_min", "start_min", "day", "seg", "lat_next", "n_samp",
            "c_start")
NS_F = len(_F_NAMES)
NS_I = len(_I_NAMES)
assert NS_F == 64 and NS_I == 7
# the auto-reset draw cache (what _reset_cache returns)
_CACHE_NAMES = [
    n for n in _F_NAMES if n.startswith(("cx", "c_", "clat"))
] + ["c_start"]

# Random draws: every uniform is hash(lane key, counter) with counter =
# (global_step + 1) * _SITES + site (global_step = -1 for the episode
# init).  Sites [0, _PAIR_SITE) are the init/regen draws in trace order;
# the per-step noise pair and the 'nn' action pair have fixed sites.
_SITES = 64
_PAIR_SITE = 56
_NOISE_PAIR = _PAIR_SITE
_ACTION_PAIR = _PAIR_SITE + 2

# Rows of the packed policy weights (pack_policy_weights): w1 (padded to
# 16 rows), then one row each, then w2 from _W2_ROW.
_B1_ROW, _WMU_ROW, _WV_ROW, _B2_ROW, _SCAL_ROW = 16, 17, 18, 19, 20
_W2_ROW = 32


@dataclasses.dataclass(frozen=True)
class PallasRolloutConfig:
    sample_time: int = 3
    n_steps: int = 256  # env steps per call
    # patients per kernel program (a power of two; smaller batches shrink
    # it, see block_for) and warps per program
    block: int = 128
    num_warps: int = 4
    # sensor (Dexcom row of params/sensor_params.csv)
    pacf: float = 0.7
    gamma: float = -0.5444
    lam: float = 15.9574
    delta: float = 1.6898
    xi: float = -5.47
    cgm_min: float = 39.0
    cgm_max: float = 600.0
    # pump (Insulet row of params/pump_params.csv)
    inc_basal: float = 0.05
    min_basal: float = 0.0
    max_basal: float = 30.0
    inc_bolus: float = 0.05
    min_bolus: float = 0.0
    max_bolus: float = 30.0
    # controller: 'pid' | 'bb' | 'const' | 'nn'.  'nn' runs the Gaussian
    # MLP policy of rl/policy.py INSIDE the kernel (relu trunk, action
    # sampling from the in-kernel generator) — the fused PPO actor
    # (rl/fused.py).  Weights arrive as an extra input built by
    # :func:`pack_policy_weights`; the kernel additionally outputs the raw
    # pre-squash action and the controller's observation inputs so the
    # learner can recompute logp/value outside (one batched XLA forward).
    controller: str = "pid"
    nn_hidden: int = 64  # MLP width ('nn' controller); a power of two
    nn_action_scale: float = 0.2  # basal = sigmoid(raw) * scale (policy.py)
    # scale the 'nn' action by the patient's own basal rate (u2ss*BW/6000,
    # the plane pack_params already ships): basal = sigmoid(raw) * scale *
    # patient_basal — one policy output means the same THERAPY INTENSITY for
    # a 25 kg child and a 110 kg adult (cohort basals span ~6x).  The
    # deploy-side analog is policy_controller(..., basal=...) in
    # rl/evaluate.py.
    nn_scale_by_basal: bool = False
    # nn_sample_actions=False: the policy emits its MEAN action (raw = mu,
    # no Gaussian exploration) while the ENV stays stochastic (CGM noise,
    # random meals, resets) — the deployment/evaluation mode of a trained
    # policy (rl/evaluate.policy_controller's law) at kernel speed.
    nn_sample_actions: bool = True
    # nn_decoder='residual_bb': the policy MODULATES basal-bolus therapy
    # instead of emitting an absolute rate — insulin = quantize(bb_cmd *
    # exp(nn_action_scale * tanh(raw))) where bb_cmd is the per-patient
    # basal + announced-meal/correction bolus from the Quest CR/CF planes
    # (the same math as the 'bb' controller branch; reference
    # basal_bolus_ctrller.py:34-80).  A zero-output policy IS BB therapy;
    # bolus-sized doses are reachable (the absolute sigmoid decoder's
    # ceiling caps them — BASELINE.md round-5).  pack_params MUST be given
    # quest= for this config (the CR/CF planes default to a sentinel).
    # nn_scale_by_basal is ignored; nn_action_scale is the log-range.
    nn_decoder: str = "sigmoid"
    # persistent_state=True: the full simulator state streams in/out of the
    # kernel as device arrays, so consecutive calls CONTINUE episodes (the
    # PPO trainer's env-state carry across iterations).  run() then takes
    # (state_f, state_i, init) and returns them updated; init=1 ignores the
    # incoming state and draws fresh episodes.
    persistent_state: bool = False
    pid_p: float = -1e-4
    pid_i: float = -1e-7
    pid_d: float = 0.0
    pid_target: float = 140.0
    bb_target: float = 140.0  # basal_bolus_ctrller.py:28 (default target)
    const_basal: float = 0.0
    # reward law: 'risk_diff' (the reference default, env.py:27-33) or
    # 'neg_risk' (dense -RI/10 — analysis/risk.py neg_risk_reward; the
    # per-episode-telescoping risk_diff is a near-zero-mean signal for RL,
    # see tests/test_ppo.py design notes)
    reward_kind: str = "risk_diff"
    # env
    bg_done_low: float = 70.0
    bg_done_high: float = 350.0
    random_init_bg: bool = True
    # autoreset=False: run fixed-horizon through BG excursions (the
    # reference's SimObj/batch_sim semantics — sim_engine.py:29-39 never
    # resets); done is still reported.
    autoreset: bool = True
    # >= 0: every lane starts at this minute-of-day (simulate()'s fixed
    # start_time); < 0: per-lane random start hour (gym semantics)
    fixed_start_min: int = -1
    # deterministic=True: no noise, no random meals, no resets, x0 init —
    # the exact-parity-vs-env_step test configuration.  det_meal_* give an
    # optional STATIC meal schedule (absolute episode minutes -> grams,
    # identical for every lane), the kernel analog of the env path's
    # exogenous meal_seq / the reference CustomScenario
    # (simulation/scenario.py:21-45) — exercises the eating state machine
    # and the BB bolus path under exact parity.
    deterministic: bool = False
    det_meal_times: tuple = ()
    det_meal_amounts: tuple = ()
    # scenario law for the STOCHASTIC config (ignored when deterministic):
    # 'random' — per-lane daily meal plans redrawn at midnight (the
    # reference RandomScenario, scenario_gen.py:10-73); 'static' — the
    # det_meal_times/det_meal_amounts schedule (absolute episode minutes),
    # i.e. a CustomScenario (scenario.py:21-45) WITH CGM noise / random
    # init BG / resets still active — this is how simulate() keeps custom
    # meal scenarios on the kernel fast path.  Under autoreset the schedule
    # replays from each new episode's minute 0.
    scenario_kind: str = "random"
    # Rare-path sampling cadence: the day-rollover meal-plan redraw and the
    # auto-reset value draw run only on every regen_every-th (global) step
    # instead of every step (they are ~half the per-step transcendental
    # budget).  Deferring a midnight redraw is OBSERVATIONALLY EXACT for up
    # to 288 simulated minutes: meal-slot times all lie at >= 300
    # min-of-day (reference scenario_gen.py:39, breakfast lower bound 5 am),
    # so neither the outgoing nor the incoming plan can fire during the
    # deferral window.  Reset draws are cached per lane at the same
    # cadence; a lane terminating twice within one window reuses its cached
    # draw (episodes ~125 steps at the default laws vs a window of
    # regen_every steps — negligible correlation).  Constraint:
    # regen_every * sample_time <= 288.  Set to 1 to restore per-step draws.
    regen_every: int = 8
    # exogenous_noise=True: CGM noise comes from caller-supplied planes
    # (reset_noise [2, B] + step_noise [n_steps, B]) indexed exactly like
    # the env path's EnvParams.noise_seq (devices/cgm.py) — 2 reset pops
    # then one per step.  This is how the kernel is golden-verified against
    # the env path (and hence the reference, sensor/noise_gen.py:15-69)
    # with IDENTICAL noise, not just distribution-matched.  Requires
    # autoreset=False.
    exogenous_noise: bool = False


def config_for_sensor(sensor: str = "Dexcom", **overrides) -> "PallasRolloutConfig":
    """PallasRolloutConfig with the named sensor's parameter row (sample
    time, AR(1)/Johnson-SU noise constants, clamp range) filled in from the
    params table (params/sensor_params.csv — Dexcom/GuardianRT/Navigator)."""
    from simglucose_tpu.params import sensor_record

    rec = sensor_record(sensor)
    fields = dict(
        sample_time=int(rec["sample_time"]),
        pacf=float(rec["PACF"]),
        gamma=float(rec["gamma"]),
        lam=float(rec["lambda"]),
        delta=float(rec["delta"]),
        xi=float(rec["xi"]),
        cgm_min=float(rec["min"]),
        cgm_max=float(rec["max"]),
    )
    fields.update(overrides)
    return PallasRolloutConfig(**fields)


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def block_for(batch: int, block: int) -> int:
    """Patients per program for a ``batch``-patient call: the configured
    ``block``, shrunk to the next power of two >= batch for small cohorts
    (never below MIN_BLOCK) so a 30-patient run is one 32-lane program, not
    a 128-lane one that is 77% padding."""
    if not _is_pow2(block) or block < MIN_BLOCK:
        raise ValueError(
            f"block must be a power of two >= {MIN_BLOCK}; got {block}"
        )
    small = max(MIN_BLOCK, 1 << max(0, (batch - 1).bit_length()))
    return min(block, small)


def pack_params(
    params: PatientParams, basal: jnp.ndarray, quest=None
) -> jnp.ndarray:
    """PatientParams [B] -> packed [NP_PLANES, B] planes.

    ``quest`` (any object with per-patient ``.CR``/``.CF`` arrays, e.g.
    :class:`simglucose_tpu.core.types.QuestParams`) is required for the
    configs that READ the Quest planes — ``controller='bb'`` and
    ``nn_decoder='residual_bb'``.  When quest is omitted those planes are
    filled with a finite ``-1.0`` sentinel that :func:`_unpack_params`
    converts to NaN inside the kernel, so a quest-reading config fails
    LOUDLY (NaN insulin/BG at the first meal or correction) instead of
    silently dosing with CR=CF=1 — meal-gram-sized insulin rates.  PID /
    const / sigmoid-decoder 'nn' configs never touch the planes.  The
    sentinel is finite (not NaN) on purpose: multi-process
    ``jax.device_put`` of the packed array onto a mesh sharding verifies
    the value is identical on every host with ``==``, and NaN != NaN
    would fail that check for hosts holding bit-identical arrays."""
    cols = [getattr(params, f) for f in _PARAM_FIELDS]
    cols += [params.x0[:, i] for i in range(13)]
    sentinel = jnp.full_like(jnp.asarray(basal, jnp.float32), -1.0)
    cols += [basal]
    cols += [quest.CR, quest.CF] if quest is not None else [sentinel, sentinel]
    return jnp.stack([jnp.asarray(c, jnp.float32) for c in cols])  # [NP, B]


def packed_basal(packed: jnp.ndarray) -> jnp.ndarray:
    """The per-patient basal plane of :func:`pack_params` ([B]) — the fused
    learner's featurize input (rl/policy.py featurize_parts needs the
    patient basal; the kernel reads the same plane in-kernel)."""
    return packed[len(_PARAM_FIELDS) + 13]


def pack_policy_weights(params) -> jnp.ndarray:
    """PolicyParams (rl/policy.py) -> one [32 + H, H] f32 buffer for the
    kernel's 'nn' controller.

    Row layout (H = hidden width, OBS_DIM = 7): [0:7] w1 (rows 7..15 zero)
    | [16] b1 | [17] w_mu | [18] w_v | [19] b2 | [20, 0:3] (b_mu, log_std,
    b_v) | [32:32+H] w2.

    The kernel's trunk is hardwired relu; params carrying any other static
    ``act`` metadata (rl/policy.py PolicyParams) are rejected so a
    tanh-trained checkpoint cannot silently run as a different network."""
    act = getattr(params, "act", "relu")
    if act != "relu":
        raise ValueError(
            f"the pallas 'nn' controller implements a relu trunk; got "
            f"params with act={act!r} (train/init the policy with "
            f"act='relu' to use the fused actor)"
        )
    H = params.b1.shape[0]
    if params.w1.shape[0] != 7:
        raise ValueError(
            f"the pallas 'nn' controller implements the OBS_DIM=7 featurizer "
            f"(rl/policy.py featurize_parts); got w1 with obs dim "
            f"{params.w1.shape[0]}"
        )
    f32 = jnp.float32
    buf = jnp.zeros((_W2_ROW + H, H), f32)
    buf = buf.at[0:7].set(params.w1.astype(f32))
    buf = buf.at[_B1_ROW].set(params.b1.astype(f32))
    buf = buf.at[_WMU_ROW].set(params.w_mu[:, 0].astype(f32))
    buf = buf.at[_WV_ROW].set(params.w_v[:, 0].astype(f32))
    buf = buf.at[_B2_ROW].set(params.b2.astype(f32))
    buf = buf.at[_SCAL_ROW, 0].set(params.b_mu[0].astype(f32))
    buf = buf.at[_SCAL_ROW, 1].set(params.log_std[0].astype(f32))
    buf = buf.at[_SCAL_ROW, 2].set(params.b_v[0].astype(f32))
    buf = buf.at[_W2_ROW:].set(params.w2.astype(f32))
    return buf


def _unpack_params(pref) -> tuple:
    """Packed planes ref -> (PatientParams-like namespace of [block], x0
    tuple, (basal, CR, CF))."""
    vals = {f: pref[i] for i, f in enumerate(_PARAM_FIELDS)}
    n = len(_PARAM_FIELDS)
    x0 = tuple(pref[n + i] for i in range(13))
    basal = pref[n + 13]
    # pack_params fills CR/CF with a finite -1.0 sentinel when quest is
    # omitted (real Quest values are strictly positive); convert to NaN
    # here so quest-READING configs still poison their doses loudly while
    # the packed array itself stays NaN-free (multi-process device_put
    # compares hosts' values with ==, where NaN != NaN).  Dead code for
    # configs that never touch the planes.
    CR = pref[n + 14]
    CF = pref[n + 15]
    CR = jnp.where(CR > 0, CR, jnp.nan)
    CF = jnp.where(CF > 0, CF, jnp.nan)
    # PatientParams requires x0; give it a dummy (kernel never uses .x0)
    p = PatientParams(x0=x0[0], **vals)
    return p, x0, (basal, CR, CF)


# ---------------------------------------------------------------------------
# In-kernel random numbers
# ---------------------------------------------------------------------------


def _fmix32(x):
    """murmur3's 32-bit finalizer: a bijection with full avalanche."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    return x ^ (x >> 16)


def _as_u32(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.uint32)


def lane_keys(seed, lanes):
    """Per-lane stream keys: hash of (seed, global lane index).  For a
    fixed seed the map lane -> key is a bijection, so no two lanes of one
    call share a stream."""
    s = _fmix32(_as_u32(seed) * jnp.uint32(0x9E3779B9) + jnp.uint32(0x7F4A7C15))
    return _fmix32(s ^ (_as_u32(lanes) * jnp.uint32(0x85EBCA6B)))


def draw_bits(key, ctr):
    """32 random bits per lane for draw counter ``ctr`` (uint32 scalar).
    For a fixed lane key, distinct counters give distinct outputs
    (``ctr * odd`` and both mixes are bijections)."""
    x = key ^ (ctr * jnp.uint32(0x632BE59B))
    return _fmix32(_fmix32(x) + key)


class _Rng:
    """Draw sites of one (lane key, global step): the n-th ``bits`` call
    traced for this step uses counter (step + 1) * _SITES + site0 + n."""

    def __init__(self, key, step, site0: int = 0, limit: int = _PAIR_SITE):
        self._key = key
        self._base = _as_u32(step + 1) * jnp.uint32(_SITES)
        self._n = site0
        self._limit = limit

    def bits(self):
        if self._n >= self._limit:
            raise AssertionError("too many draws for one step's site budget")
        ctr = self._base + jnp.uint32(self._n)
        self._n += 1
        return draw_bits(self._key, ctr)


def _uniform(rng):
    """U(0,1) in [1e-7, 1): random bits -> float via the exponent trick."""
    bits = rng.bits()
    f = jax.lax.bitcast_convert_type(
        (bits >> 9) | jnp.uint32(0x3F800000), jnp.float32
    )
    return jnp.maximum(f - 1.0, 1e-7)  # [1.0, 2.0) -> [1e-7, 1.0)


def _normal_pair(rng):
    """Two N(0,1) draws per lane via Box-Muller."""
    u1 = _uniform(rng)
    u2 = _uniform(rng)
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    th = (2.0 * math.pi) * u2
    return r * jnp.cos(th), r * jnp.sin(th)


def _ndtri_central(p):
    """Central branch of Acklam's inverse-normal-CDF rational — no sqrt/log.

    Valid (|abs err| < 4e-8) for p in [0.0227, 0.9773] (the +/-2 sigma CDF
    window); used for the truncnorm meal-time draws whose CDF ranges are
    static per slot and known to fit (checked against scipy.ndtri)."""
    a = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
    b = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01)
    q = p - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r) + 1.0
    return num * q / den


def _ndtri(p):
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |rel err| < 1.15e-9 — far below the f32 ulp)."""
    a = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
         1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
    b = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
         6.680131188771972e01, -1.328068155288572e01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
         -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
         3.754408661907416e00)
    plow = 0.02425
    p = jnp.clip(p, 1e-7, 1.0 - 1e-7)

    # central region
    q = p - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r) + 1.0
    x_c = num * q / den

    # lower tail
    ql = jnp.sqrt(-2.0 * jnp.log(p))
    num_l = ((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]
    den_l = (((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql + 1.0
    x_l = num_l / den_l

    # upper tail (symmetry)
    qu = jnp.sqrt(-2.0 * jnp.log(1.0 - p))
    num_u = ((((c[0] * qu + c[1]) * qu + c[2]) * qu + c[3]) * qu + c[4]) * qu + c[5]
    den_u = (((d[0] * qu + d[1]) * qu + d[2]) * qu + d[3]) * qu + 1.0
    x_u = -num_u / den_u

    return jnp.where(p < plow, x_l, jnp.where(p > 1.0 - plow, x_u, x_c))


# ---------------------------------------------------------------------------
# In-kernel simulator pieces (all on [block] vectors)
# ---------------------------------------------------------------------------


def round_half_even(x):
    """``jnp.round`` (round half to even) from floor — the Triton route
    has no rounding primitive.  Exact for |x| < 2**22, far above any
    pump or meal value rounded here."""
    r = jnp.floor(x + 0.5)
    tie = (r - x) == 0.5
    odd = (r - 2.0 * jnp.floor(r * 0.5)) != 0.0
    return jnp.where(tie & odd, r - 1.0, r)


def _johnson(cfg: PallasRolloutConfig, x):
    # sinh via exp (one transcendental instead of sinh's two)
    z = (x - cfg.gamma) / cfg.delta
    ez = jnp.exp(z)
    return cfg.xi + cfg.lam * 0.5 * (ez - 1.0 / ez)


def _catmull(l0, l1, l2, l3, u):
    m1 = 0.5 * (l2 - l0)
    m2 = 0.5 * (l3 - l1)
    u2 = u * u
    u3 = u2 * u
    return (
        (2.0 * u3 - 3.0 * u2 + 1.0) * l1
        + (u3 - 2.0 * u2 + u) * m1
        + (-2.0 * u3 + 3.0 * u2) * l2
        + (u3 - u2) * m2
    )


def _quantize(amount, inc, lo, hi):
    """Pump quantization (reference actuator/pump.py:23-39)."""
    return jnp.clip(
        round_half_even(amount * 6000.0 / inc) * inc / 6000.0, lo, hi
    )


def _draw_meal_plan(cfg: PallasRolloutConfig, rng):
    """One day's meal plan: (times[6], amounts[6]) of [block] vectors.

    Transcendental-lean: amount normals come from 3 Box-Muller pairs and
    the truncnorm times use the rational-only central inverse-CDF branch
    (their CDF windows are static +/-2 sigma; slot 5 spans +/-3 sigma and
    keeps the full 3-branch inverse)."""
    times, amounts = [], []
    amt_z = []
    for _ in range(3):
        z1, z2 = _normal_pair(rng)
        amt_z += [z1, z2]
    for s in range(6):
        u_occ = _uniform(rng)
        u_t = _uniform(rng)
        mu, sig = _TIME_MU[s], _TIME_SIGMA[s]
        a_cdf = 0.5 * (1.0 + math.erf((_TIME_LB[s] - mu) / sig / math.sqrt(2.0)))
        b_cdf = 0.5 * (1.0 + math.erf((_TIME_UB[s] - mu) / sig / math.sqrt(2.0)))
        inv = _ndtri if min(a_cdf, 1.0 - b_cdf) < 0.0227 else _ndtri_central
        t = round_half_even(mu + sig * inv(a_cdf + u_t * (b_cdf - a_cdf)))
        amt = jnp.maximum(
            round_half_even(_AMOUNT_MU[s] + _AMOUNT_SIGMA[s] * amt_z[s]), 0.0
        )
        occurs = u_occ < _MEAL_PROB[s]
        times.append(jnp.where(occurs, t, -1.0))
        amounts.append(jnp.where(occurs, amt, 0.0))
    return times, amounts


def _rk4_minute(p, xs, d_mg, insulin_rate, Dbar):
    """One classic RK4 minute (envs' rk4_step at h=1) as a loop over the
    four stages — one copy of the RHS in the kernel instead of four, which
    keeps the GPU compile short.  Same arithmetic, in the same order, as
    x + (1/6) * (k1 + 2 k2 + 2 k3 + k4)."""
    zero = tuple(jnp.zeros_like(x) for x in xs)

    def stage(s, carry):
        acc, k = carry
        # stage coefficients as arithmetic, not a select of two constants
        # (exact: 0.5 + 0.5 = 1, 1 + 1 = 2); stage 0 adds 0.5 * 0
        c = 0.5 + 0.5 * (s == 3).astype(jnp.float32)
        ys = tuple(x + c * kk for x, kk in zip(xs, k))
        k = model_rhs_parts(ys, p, d_mg, insulin_rate, Dbar)
        w = 1.0 + ((s == 1) | (s == 2)).astype(jnp.float32)
        acc = tuple(
            jnp.where(s == 0, kk, a + w * kk) for a, kk in zip(acc, k)
        )
        return acc, k

    acc, _ = jax.lax.fori_loop(jnp.int32(0), jnp.int32(4), stage, (zero, zero))
    return tuple(x + (1.0 / 6.0) * a for x, a in zip(xs, acc))


def _risk_of(bg):
    logbg = jnp.log(jnp.maximum(bg, 1.0))
    f = 1.509 * (jnp.power(logbg, 1.084) - 5.381)
    return 10.0 * f * f


def _reset_values(cfg: PallasRolloutConfig, rng, x0, zero):
    """A fresh episode's patient and sensor state: initial ODE state (with
    the random initial BG), the noise lattice and the start minute.  The
    meal plan is not part of it: daily plans are i.i.d., so an auto-reset
    episode keeps the current plan, and a fresh run draws one at its first
    step."""
    xs = list(x0)
    lattice_needed = not (cfg.deterministic or cfg.exogenous_noise)
    # 6 normals (3 init-BG + 3 noise-lattice) from exactly 3 Box-Muller pairs
    lat_z = None
    if not cfg.deterministic:
        if cfg.random_init_bg and lattice_needed:
            za, zb = _normal_pair(rng)
            zc, zd = _normal_pair(rng)
            ze, zf = _normal_pair(rng)
            for idx, z in ((3, za), (4, zb), (12, zc)):
                xs[idx] = x0[idx] + jnp.sqrt(0.1 * x0[idx]) * z
            lat_z = (zd, ze, zf)
        elif cfg.random_init_bg:
            za, zb = _normal_pair(rng)
            zc, _ = _normal_pair(rng)
            for idx, z in ((3, za), (4, zb), (12, zc)):
                xs[idx] = x0[idx] + jnp.sqrt(0.1 * x0[idx]) * z
        elif lattice_needed:
            za, zb = _normal_pair(rng)
            zc, _ = _normal_pair(rng)
            lat_z = (za, zb, zc)
    f = {"xs": tuple(xs)}
    # sensor lattice init (ops/noise.py:52-73)
    if lat_z is None:
        f["e"] = zero
        f["lat"] = (zero, zero, zero, zero)
    else:
        e0 = lat_z[0]
        e1 = cfg.pacf * (e0 + lat_z[1])
        e2 = cfg.pacf * (e1 + lat_z[2])
        f["e"] = e2
        j0 = _johnson(cfg, e0)
        f["lat"] = (j0, j0, _johnson(cfg, e1), _johnson(cfg, e2))
    zero_i = zero.astype(jnp.int32)
    if cfg.deterministic:
        f["start_min"] = zero_i
    elif cfg.fixed_start_min >= 0:
        f["start_min"] = zero_i + cfg.fixed_start_min
    else:
        hour = jnp.floor(_uniform(rng) * 24.0).astype(jnp.int32)
        f["start_min"] = hour * 60
    return f


def _reset_cache(cfg, rng, x0, p, zero) -> dict:
    """The auto-reset draw cache: a fresh episode's values, with the
    derived reset CGM and its risk (avoids a clip+log+pow every step)."""
    rc = _reset_values(cfg, rng, x0, zero)
    S = {f"cx{i}": rc["xs"][i] for i in range(13)}
    S["c_e"] = rc["e"]
    for i in range(4):
        S[f"clat{i}"] = rc["lat"][i]
    cgm0 = jnp.clip(rc["xs"][12] / p.Vg + rc["lat"][1], cfg.cgm_min, cfg.cgm_max)
    S["c_cgm0"] = cgm0
    S["c_risk0"] = _risk_of(cgm0)
    S["c_start"] = rc["start_min"]
    return S


def _fresh_state(cfg, rng, p, x0, zero, rnoise):
    """(state dict, BG0, CGM0 history sample) of a fresh episode — the
    env reset (reference env.py:119-134).  The episode starts from one
    reset draw (the same code as the auto-reset cache), with no meal plan
    and day -1: the regen at the run's first step draws the day's plan and
    refreshes the cache."""
    C = _reset_cache(cfg, rng, x0, p, zero)
    zero_i = zero.astype(jnp.int32)
    S = dict(C)
    for i in range(13):
        S[f"x{i}"] = C[f"cx{i}"]
    bg0 = C["cx12"] / p.Vg
    if cfg.exogenous_noise:
        # the env's reset draws TWO noise pops (env.py:126,142): [0] ->
        # history row 0 / reward window, [1] -> the obs the first
        # controller call acts on
        cgm_hist0 = jnp.clip(bg0 + rnoise[0], cfg.cgm_min, cfg.cgm_max)
        cgm_obs0 = jnp.clip(bg0 + rnoise[1], cfg.cgm_min, cfg.cgm_max)
        risk0 = _risk_of(cgm_hist0)
    else:
        # Catmull-Rom at tau=0 is exactly lat[1] (zero when deterministic)
        cgm_hist0 = cgm_obs0 = C["c_cgm0"]
        risk0 = C["c_risk0"]
    S.update(
        planned=zero, last_CHO=zero, eating=zero,
        last_Qsto=C["cx0"] + C["cx1"], foodtaken=zero,
        last_CGM=cgm_obs0, e=C["c_e"],
        pid_integ=zero, pid_prev=zero,
        # prev risk = risk(reset history sample); the first step's reward
        # is risk(reset CGM) - risk(step CGM), matching env_reset's
        # window = [CGM_hist0] + first-step window_len == 2 (env.py:126,100)
        prev_risk=risk0,
        prev_cho=zero,
        ctrl_prev=cgm_obs0,  # the first controller observation
        ins_prev=zero,
        ctrl_pprev=cgm_obs0,  # == ctrl_prev -> zero trend
        iob=zero,
        t_min=zero_i, start_min=C["c_start"], day=zero_i - 1, seg=zero_i,
        lat_next=zero_i + 3, n_samp=zero_i,
    )
    for i in range(4):
        S[f"lat{i}"] = C[f"clat{i}"]
    for s in range(6):
        S[f"mt{s}"] = zero - 1.0
        S[f"ma{s}"] = zero
    return S, bg0, cgm_hist0


def _make_kernel(cfg: PallasRolloutConfig, block: int):
    st = cfg.sample_time
    T = cfg.n_steps
    nn = cfg.controller == "nn"
    H = cfg.nn_hidden
    stochastic = not cfg.deterministic
    native_noise = stochastic and not cfg.exogenous_noise
    sample_actions = nn and stochastic and cfg.nn_sample_actions

    def policy_mean(wref, feats):
        """Relu MLP trunk on [block] features -> mean action [block], as
        f32 FMAs: a loop over the H first-layer units, each unit's [block]
        activation accumulated into the [block, H] second layer.  (A Triton
        dot at f32 precision measured 64x slower on the H100: it takes no
        tensor cores and converts layouts through shared memory each
        step.)  Full f32, like the XLA policy forward
        (rl/policy.policy_apply, precision HIGHEST)."""
        def unit(k, acc):
            h1 = wref[_B1_ROW, k]
            for j, fj in enumerate(feats):
                h1 = h1 + fj * wref[j, k]
            h1 = jnp.maximum(h1, 0.0)
            return acc + h1[:, None] * wref[_W2_ROW + k][None, :]

        acc = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(H), unit,
            jnp.zeros((block, H), jnp.float32),
        )
        h = jnp.maximum(acc + wref[_B2_ROW][None, :], 0.0)
        return jnp.sum(h * wref[_WMU_ROW][None, :], axis=1)

    def kernel(*refs):
        # inputs: scal (seed, init, step0, lane0), params, [weights],
        # [rnoise, noise], [state_f, state_i]; outputs: 6 traj planes,
        # [6 'nn' planes], rst, [state_f_out, state_i_out]
        it = iter(refs)
        scal_ref, pref = next(it), next(it)
        wref = next(it) if nn else None
        rnoise_ref = noise_ref = None
        if cfg.exogenous_noise:
            rnoise_ref, noise_ref = next(it), next(it)
        sf_in = si_in = None
        if cfg.persistent_state:
            sf_in, si_in = next(it), next(it)
        traj_refs = [next(it) for _ in range(6)]
        nn_refs = [next(it) for _ in range(6)] if nn else None
        rst_ref = next(it)
        if cfg.persistent_state:
            sf_out, si_out = next(it), next(it)

        seed, step0 = scal_ref[0], scal_ref[2]
        # non-persistent configs always start fresh
        init = scal_ref[1] if cfg.persistent_state else 1
        lanes = (
            scal_ref[3] + pl.program_id(0) * block
            + jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
        )
        key = lane_keys(seed, lanes) if stochastic else None
        zero = jnp.zeros((block,), jnp.float32)

        p, x0, _ = _unpack_params(pref)
        rnoise = (
            (rnoise_ref[0], rnoise_ref[1]) if cfg.exogenous_noise else None
        )
        rng0 = _Rng(key, step0 - 1) if stochastic else None
        S, bg0, cgm_hist0 = _fresh_state(cfg, rng0, p, x0, zero, rnoise)
        if cfg.persistent_state:
            # continue the incoming episodes unless this is an init call
            fresh = init == 1
            for i, n in enumerate(_F_NAMES):
                S[n] = jnp.where(fresh, S[n], sf_in[i])
            for i, n in enumerate(_I_NAMES):
                S[n] = jnp.where(fresh, S[n], si_in[i])
        # reset observation (the frame's row 0, reference env.py:119-134);
        # meaningful on init calls only
        rst_ref[0] = bg0
        rst_ref[1] = cgm_hist0

        def pair(site, g, t, spare):
            """One Box-Muller pair serves two consecutive global steps: the
            even step draws it and carries the second half; a call that
            starts on an odd step redraws its pair (counter-based, so the
            stream is identical to an unchunked run)."""
            def draw():
                even = g - g % 2
                z = _normal_pair(_Rng(key, even, site, site + 2))
                first = g % 2 == 0
                return jnp.where(first, z[0], z[1]), z[1]

            return jax.lax.cond(
                (g % 2 == 0) | (t == 0), draw, lambda: (spare, spare)
            )

        def step(t, carry):
            S, z_spare, a_spare = carry
            S = dict(S)
            g = step0 + t  # global step index (continues across calls)
            p, x0, (basal, CR, CF) = _unpack_params(pref)

            # ---- controller acts on the previous step's observation,
            # exactly like the closed loop (sim_engine.py:33-37) ----
            ctrl_prev, prev_cho = S["ctrl_prev"], S["prev_cho"]
            if nn:
                # featurize (rl/policy.py featurize_parts)
                b8 = basal + 1e-8
                feats = (
                    ctrl_prev * (1.0 / 400.0),
                    (ctrl_prev - 140.0) * 0.01,
                    jnp.tanh(S["ins_prev"] / (3.0 * b8)),
                    jnp.tanh(prev_cho * 0.1),
                    jnp.tanh((ctrl_prev - S["ctrl_pprev"]) * 0.1),
                    jnp.tanh(S["iob"] / (120.0 * b8)),
                    jnp.tanh(20.0 * basal),
                )
                # the controller's observation inputs: the learner
                # reconstructs featurize() from these (rl/fused.py)
                for ref, v in zip(
                    nn_refs[1:],
                    (ctrl_prev, S["ins_prev"], prev_cho, S["ctrl_pprev"],
                     S["iob"]),
                ):
                    ref[t] = v
                scal = wref[_SCAL_ROW]
                col = jax.lax.broadcasted_iota(jnp.int32, (H,), 0)
                mu = policy_mean(wref, feats) + jnp.sum(
                    jnp.where(col == 0, scal, 0.0)
                )
                if sample_actions:
                    za, a_spare = pair(_ACTION_PAIR, g, t, a_spare)
                    sigma = jnp.exp(jnp.sum(jnp.where(col == 1, scal, 0.0)))
                    raw = mu + sigma * za
                else:
                    raw = mu  # policy-mean actions (deployment/eval mode)
                nn_refs[0][t] = raw
                if cfg.nn_decoder == "residual_bb":
                    # BB therapy command (reference basal_bolus_ctrller.py:
                    # 34-80) modulated by the policy within
                    # [exp(-scale), exp(+scale)]; the pump quantizes the
                    # FINAL command (eval-path controller + env pump)
                    bolus_u = (prev_cho * st) / CR + (
                        ctrl_prev > 150.0
                    ).astype(jnp.float32) * (ctrl_prev - cfg.bb_target) / CF
                    bolus_cmd = jnp.where(prev_cho > 0, bolus_u / st, 0.0)
                    mod = jnp.exp(cfg.nn_action_scale * jnp.tanh(raw))
                    insulin = _quantize(
                        (basal + bolus_cmd) * mod, cfg.inc_basal,
                        cfg.min_basal, cfg.max_basal,
                    )
                else:
                    # squashed Gaussian -> basal (rl/policy.py
                    # sample_action), then pump quantization
                    basal_cmd = cfg.nn_action_scale / (1.0 + jnp.exp(-raw))
                    if cfg.nn_scale_by_basal:
                        basal_cmd = basal_cmd * basal
                    insulin = _quantize(
                        basal_cmd, cfg.inc_basal, cfg.min_basal,
                        cfg.max_basal,
                    )
                # insulin-on-board update (rl/policy.py iob_step)
                S["iob"] = S["iob"] * math.exp(-st / 100.0) + insulin * float(st)
            elif cfg.controller == "pid":
                obs = ctrl_prev
                control = (
                    cfg.pid_p * (obs - cfg.pid_target)
                    + cfg.pid_i * S["pid_integ"]
                    + cfg.pid_d * (obs - S["pid_prev"]) / st
                )
                S["pid_integ"] = S["pid_integ"] + (obs - cfg.pid_target) * st
                S["pid_prev"] = obs
                insulin = _quantize(
                    control, cfg.inc_basal, cfg.min_basal, cfg.max_basal
                )
            elif cfg.controller == "bb":
                # basal-bolus therapy on the previous step's CGM + announced
                # meal (controllers/functional.py bb_controller, reference
                # basal_bolus_ctrller.py:34-80): bolus only when meal > 0
                bolus_u = (prev_cho * st) / CR + (
                    ctrl_prev > 150.0
                ).astype(jnp.float32) * (ctrl_prev - cfg.bb_target) / CF
                bolus_cmd = jnp.where(prev_cho > 0, bolus_u / st, 0.0)
                insulin = _quantize(
                    basal, cfg.inc_basal, cfg.min_basal, cfg.max_basal
                ) + _quantize(
                    bolus_cmd, cfg.inc_bolus, cfg.min_bolus, cfg.max_bolus
                )
            else:
                insulin = _quantize(
                    zero + cfg.const_basal, cfg.inc_basal, cfg.min_basal,
                    cfg.max_basal,
                )

            # ---- scenario redraw + reset-cache refresh at the regen_every
            # cadence.  A deferred midnight regen is observationally exact
            # because no meal slot fires before 5 am (regen_every docs) ----
            if stochastic and (
                cfg.scenario_kind == "random" or cfg.autoreset
            ):
                keys = []
                if cfg.scenario_kind == "random":
                    keys += [f"mt{s}" for s in range(6)]
                    keys += [f"ma{s}" for s in range(6)] + ["day"]
                if cfg.autoreset:
                    keys += _CACHE_NAMES

                def regen(sub):
                    sub = dict(sub)
                    rng = _Rng(key, g)
                    if cfg.scenario_kind == "random":
                        mins_last = S["start_min"] + S["t_min"] + (st - 1)
                        day_end = mins_last // MINUTES_PER_DAY
                        new = day_end > sub["day"]
                        new_t, new_a = _draw_meal_plan(cfg, rng)
                        for s in range(6):
                            sub[f"mt{s}"] = jnp.where(new, new_t[s], sub[f"mt{s}"])
                            sub[f"ma{s}"] = jnp.where(new, new_a[s], sub[f"ma{s}"])
                        sub["day"] = jnp.maximum(sub["day"], day_end)
                    if cfg.autoreset:
                        sub.update(_reset_cache(cfg, rng, x0, p, zero))
                    return sub

                # a fresh run regens at its first step whatever the cadence
                # (the day's plan and the reset cache, see _fresh_state)
                first = (t == 0) & (init == 1)
                S.update(jax.lax.cond(
                    (g % cfg.regen_every == 0) | first, regen, dict,
                    {k: S[k] for k in keys},
                ))

            if native_noise:
                z, z_spare = pair(_NOISE_PAIR, g, t, z_spare)

            def minute(m, c):
                """One patient-minute: meal lookup, eating state machine,
                RK4 (the inputs are held over the minute)."""
                (xs, planned, last_CHO, eating, last_Qsto, foodtaken, t_min,
                 CHO_acc, BG_acc, _) = c
                # meal for this minute (first-match lookup,
                # scenario.py:37-42)
                meal = zero
                if cfg.deterministic or cfg.scenario_kind == "static":
                    # static schedule: absolute episode minute -> grams
                    # (the exogenous meal_seq / CustomScenario analog)
                    for tt, aa in zip(cfg.det_meal_times, cfg.det_meal_amounts):
                        meal = jnp.where(t_min == tt, meal + aa, meal)
                else:
                    # t_min advances per minute, so it IS the current
                    # absolute episode minute
                    modf = (
                        (S["start_min"] + t_min) % MINUTES_PER_DAY
                    ).astype(jnp.float32)
                    taken = zero
                    for s in range(6):
                        hit = (S[f"mt{s}"] == modf).astype(jnp.float32) * (
                            1.0 - taken
                        )
                        meal = meal + hit * S[f"ma{s}"]
                        taken = jnp.maximum(taken, hit)

                # meal announcement / eating state machine (patient.py)
                planned = planned + meal
                to_eat = jnp.where(
                    planned > 0, jnp.minimum(EAT_RATE, planned), 0.0
                )
                planned = jnp.maximum(planned - to_eat, 0.0)
                starts = (to_eat > 0) & (last_CHO <= 0)
                last_Qsto = jnp.where(starts, xs[0] + xs[1], last_Qsto)
                foodtaken = jnp.where(starts, 0.0, foodtaken)
                eating_b = starts | (eating > 0)
                foodtaken = jnp.where(eating_b, foodtaken + to_eat, foodtaken)
                ends = (to_eat <= 0) & (last_CHO > 0)
                eating = (eating_b & ~ends).astype(jnp.float32)
                last_CHO = to_eat

                xs = _rk4_minute(
                    p, xs, to_eat * 1000.0, insulin * 6000.0 / p.BW,
                    last_Qsto + foodtaken * 1000.0,
                )
                bg_m = xs[12] / p.Vg
                # the reference records the ANNOUNCED scenario meal in the
                # CHO history (env.py:54,60 records action.meal, not the
                # EAT_RATE-limited eaten amount) — and the BB controller's
                # meal input is that announced value
                return (xs, planned, last_CHO, eating, last_Qsto, foodtaken,
                        t_min + 1, CHO_acc + meal / float(st),
                        BG_acc + bg_m / float(st), bg_m)

            (xs, planned, last_CHO, eating, last_Qsto, foodtaken, t_min,
             CHO_acc, BG_acc, bg_m) = jax.lax.fori_loop(
                jnp.int32(0), jnp.int32(st), minute,
                (tuple(S[f"x{i}"] for i in range(13)), S["planned"],
                 S["last_CHO"], S["eating"], S["last_Qsto"], S["foodtaken"],
                 S["t_min"], zero, zero, zero),
            )

            # fresh CGM sample at the step's last minute (devices/cgm.py +
            # ops/noise.py); the earlier minutes hold the previous sample
            if cfg.exogenous_noise:
                # noise row t = the env path's noise_seq[step + 2] (2 reset
                # pops first)
                noise = noise_ref[t]
            elif cfg.deterministic:
                noise = zero
            else:
                tau = (S["n_samp"] + 1) * st
                k = tau // MDL_SAMPLE_TIME
                u = (tau - k * MDL_SAMPLE_TIME).astype(
                    jnp.float32
                ) / MDL_SAMPLE_TIME
                need = (k + 2) >= S["lat_next"]
                e_new = cfg.pacf * (S["e"] + z)
                eps_new = _johnson(cfg, e_new)
                S["e"] = jnp.where(need, e_new, S["e"])
                lat = [S[f"lat{i}"] for i in range(4)]
                nxt = lat[1:] + [eps_new]
                for i in range(4):
                    S[f"lat{i}"] = jnp.where(need, nxt[i], lat[i])
                S["lat_next"] = S["lat_next"] + need.astype(jnp.int32)
                S["seg"] = k
                noise = _catmull(*(S[f"lat{i}"] for i in range(4)), u)
                S["n_samp"] = S["n_samp"] + 1
            CGM_acc = zero
            for _ in range(st - 1):
                CGM_acc = CGM_acc + S["last_CGM"] / float(st)
            S["last_CGM"] = jnp.clip(bg_m + noise, cfg.cgm_min, cfg.cgm_max)
            CGM_acc = CGM_acc + S["last_CGM"] / float(st)

            # ---- reward / done (env.py:100-103, risk_diff env.py:27-33);
            # risk(prev CGM) is carried from the step that produced it ----
            risk_now = _risk_of(CGM_acc)
            if cfg.reward_kind == "neg_risk":
                reward = -0.1 * risk_now
            else:
                reward = S["prev_risk"] - risk_now
            done = (BG_acc < cfg.bg_done_low) | (BG_acc > cfg.bg_done_high)

            for ref, v in zip(
                traj_refs,
                (CGM_acc, BG_acc, reward, done.astype(jnp.float32), CHO_acc,
                 insulin),
            ):
                ref[t] = v

            for i in range(13):
                S[f"x{i}"] = xs[i]
            S.update(
                planned=planned, last_CHO=last_CHO, eating=eating,
                last_Qsto=last_Qsto, foodtaken=foodtaken, t_min=t_min,
                prev_risk=risk_now, prev_cho=CHO_acc,
                ctrl_pprev=ctrl_prev,  # trend baseline: the obs acted on
                ctrl_prev=CGM_acc, ins_prev=insulin,
            )

            # ---- auto-reset (rollout.py autoreset_step semantics) from the
            # per-lane draw cache ----
            if stochastic and cfg.autoreset:
                def fresh(n, v):
                    S[n] = jnp.where(done, v, S[n])

                for i in range(13):
                    fresh(f"x{i}", S[f"cx{i}"])
                for n in ("planned", "last_CHO", "eating", "foodtaken",
                          "pid_integ", "pid_prev", "prev_cho", "ins_prev",
                          "iob"):
                    fresh(n, zero)
                fresh("last_Qsto", S["cx0"] + S["cx1"])
                fresh("e", S["c_e"])
                for i in range(4):
                    fresh(f"lat{i}", S[f"clat{i}"])
                # meal plan kept (i.i.d. across episodes — _reset_values);
                # the next controller call sees the NEW episode's reset obs
                for n in ("last_CGM", "ctrl_prev", "ctrl_pprev"):
                    fresh(n, S["c_cgm0"])
                fresh("prev_risk", S["c_risk0"])
                zero_i = zero.astype(jnp.int32)
                for n in ("t_min", "day", "seg", "n_samp"):
                    fresh(n, zero_i)
                fresh("start_min", S["c_start"])
                fresh("lat_next", zero_i + 3)
            return S, z_spare, a_spare

        S, _, _ = jax.lax.fori_loop(
            jnp.int32(0), jnp.int32(T), step, (S, zero, zero)
        )

        if nn:
            # bootstrap row: the obs the NEXT step would act on, for the
            # learner's GAE tail value (rst rows 2..6)
            for r, n in enumerate(
                ("ctrl_prev", "ins_prev", "prev_cho", "ctrl_pprev", "iob")
            ):
                rst_ref[2 + r] = S[n]
        if cfg.persistent_state:
            for i, n in enumerate(_F_NAMES):
                sf_out[i] = S[n]
            for i, n in enumerate(_I_NAMES):
                si_out[i] = S[n]

    return kernel


def _validate(cfg: PallasRolloutConfig):
    if cfg.exogenous_noise and cfg.autoreset:
        raise ValueError(
            "exogenous_noise requires autoreset=False (in-step resets would "
            "need reset-noise indexing the planes don't carry)"
        )
    if (
        cfg.controller == "nn"
        and cfg.exogenous_noise
        and not cfg.deterministic
        and cfg.nn_sample_actions
    ):
        raise ValueError(
            "'nn' + exogenous_noise requires mean actions (deterministic="
            "True or nn_sample_actions=False): the planes pin the CGM noise "
            "stream, but stochastic action sampling has no exogenous source "
            "to pin against — the noise-for-noise parity config is "
            "policy-mean actions + exogenous CGM noise "
            "(tests/test_fused_ppo.py)"
        )
    if cfg.controller not in ("pid", "bb", "const", "nn"):
        raise ValueError(f"unknown controller {cfg.controller!r}")
    if cfg.controller == "nn" and not _is_pow2(cfg.nn_hidden):
        raise ValueError(
            f"nn_hidden must be a power of two; got {cfg.nn_hidden}"
        )
    if cfg.nn_decoder not in ("sigmoid", "residual_bb"):
        raise ValueError(
            f"nn_decoder must be 'sigmoid' or 'residual_bb'; "
            f"got {cfg.nn_decoder!r}"
        )
    if cfg.scenario_kind not in ("random", "static"):
        raise ValueError(
            f"scenario_kind must be 'random' or 'static'; "
            f"got {cfg.scenario_kind!r}"
        )
    if len(cfg.det_meal_times) != len(cfg.det_meal_amounts):
        raise ValueError(
            "det_meal_times and det_meal_amounts must have the same length"
        )
    if cfg.reward_kind not in ("risk_diff", "neg_risk"):
        raise ValueError(
            f"reward_kind must be 'risk_diff' or 'neg_risk'; "
            f"got {cfg.reward_kind!r}"
        )
    if cfg.regen_every < 1 or cfg.regen_every * cfg.sample_time > 288:
        raise ValueError(
            f"regen_every={cfg.regen_every} must satisfy 1 <= regen_every "
            f"and regen_every * sample_time <= 288 (the pre-5am window that "
            f"makes deferred midnight redraws observationally exact)"
        )
    if cfg.n_steps < 1:
        raise ValueError("n_steps must be >= 1")


_TRAJ_KEYS = ("CGM", "BG", "reward", "done", "CHO", "insulin")
_NN_KEYS = ("raw", "octrl", "oins", "ocho", "oprev", "oiob")
_TAIL_KEYS = ("tail_octrl", "tail_oins", "tail_ocho", "tail_oprev",
              "tail_oiob")


def _pad_lanes(a, n: int):
    """Pad the last (patient) axis to n lanes by repeating the last
    patient — padded lanes run finite physics and are sliced away."""
    extra = n - a.shape[-1]
    if extra == 0:
        return a
    return jnp.concatenate(
        [a, jnp.repeat(a[..., -1:], extra, axis=-1)], axis=-1
    )


def make_pallas_rollout(cfg: PallasRolloutConfig, batch: int, interpret: bool = False):
    """Build the rollout: ``run(packed_params, seed, ...) -> traj dict``.

    ``packed_params`` from :func:`pack_params` ([NP_PLANES, batch]);
    returns arrays [n_steps, batch] for CGM/BG/reward/done/CHO/insulin and
    [batch] reset samples BG0/CGM0.  Any batch works: lanes are padded to
    a multiple of the program block inside and sliced back.

    With ``cfg.exogenous_noise`` the runner takes ``reset_noise`` [2, B]
    (the env's two reset pops) and ``step_noise`` [n_steps, B] (one per
    step) — the values the env path would read from
    ``EnvParams.noise_seq[0:2]`` and ``[2:n_steps+2]``.

    ``step0`` is the global index of this call's first step: the random
    streams are a function of (seed, lane, global step), so a long horizon
    run as chunks (``step0 = c * n_steps`` with persistent_state) draws
    exactly the numbers a single call would.  ``lane0`` offsets the lane
    index the same way (the sharded runner passes each device's first
    global lane, so a sharded run equals the single-device one).
    """
    _validate(cfg)
    block = block_for(batch, cfg.block)
    n_prog = -(-batch // block)
    Bp = n_prog * block
    T = cfg.n_steps
    nn = cfg.controller == "nn"
    kernel = _make_kernel(cfg, block)

    def planes(n):
        return pl.BlockSpec((n, block), lambda b: (0, b))

    def field(n, dtype=jnp.float32):
        return jax.ShapeDtypeStruct((n, Bp), dtype)

    in_specs = [pl.BlockSpec((4,), lambda b: (0,)), planes(NP_PLANES)]
    if nn:
        H = cfg.nn_hidden
        in_specs.append(pl.BlockSpec((_W2_ROW + H, H), lambda b: (0, 0)))
    if cfg.exogenous_noise:
        in_specs += [planes(2), planes(T)]
    if cfg.persistent_state:
        in_specs += [planes(NS_F), planes(NS_I)]
    n_traj = 12 if nn else 6
    n_rst = 7 if nn else 2
    out_shape = [field(T)] * n_traj + [field(n_rst)]
    out_specs = [planes(T)] * n_traj + [planes(n_rst)]
    if cfg.persistent_state:
        out_shape += [field(NS_F), field(NS_I, jnp.int32)]
        out_specs += [planes(NS_F), planes(NS_I)]

    call = pl.pallas_call(
        kernel,
        grid=(n_prog,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=pl_triton.CompilerParams(
            num_warps=cfg.num_warps, num_stages=1
        ),
        interpret=interpret,
        name=f"simglucose_rollout_{cfg.controller}",
    )

    def run(
        packed_params: jnp.ndarray,
        seed,
        reset_noise=None,
        step_noise=None,
        weights=None,
        state=None,
        init=None,
        step0=0,
        lane0=0,
    ) -> dict:
        """Run the kernel.  For 'nn' configs pass ``weights`` (from
        :func:`pack_policy_weights`).  For persistent configs pass
        ``state=(state_f, state_i)`` ([NS_F, B] / [NS_I, B]; zeros on the
        first call) and ``init`` (traced int32: 1 = draw fresh episodes and
        ignore the incoming state, 0 = continue it); the result dict then
        carries ``state_f``/``state_i`` to thread into the next call.  The
        reset rows (BG0/CGM0) are only meaningful on init=1 calls."""
        i32 = lambda v: jnp.asarray(v, jnp.int32).reshape(-1)[0]
        init_s = jnp.int32(1) if init is None else i32(init)
        scal = jnp.stack([i32(seed), init_s, i32(step0), i32(lane0)])
        pad = lambda a, dtype=jnp.float32: _pad_lanes(
            jnp.asarray(a, dtype), Bp
        )
        args = [scal, pad(packed_params)]
        if nn:
            if weights is None:
                raise ValueError("'nn' config needs weights= "
                                 "(pack_policy_weights)")
            args.append(jnp.asarray(weights, jnp.float32))
        if cfg.exogenous_noise:
            if reset_noise is None or step_noise is None:
                raise ValueError(
                    "exogenous_noise config needs reset_noise [2, B] "
                    "and step_noise [n_steps, B]"
                )
            args += [pad(reset_noise), pad(step_noise)]
        if cfg.persistent_state:
            if state is None:
                state = (
                    jnp.zeros((NS_F, batch), jnp.float32),
                    jnp.zeros((NS_I, batch), jnp.int32),
                )
            args += [pad(state[0]), pad(state[1], jnp.int32)]
        outs = call(*args)
        cut = lambda a: a[..., :batch]
        res = {k: cut(o) for k, o in zip(_TRAJ_KEYS, outs[:6])}
        res["done"] = res["done"] > 0.5
        k = 6
        if nn:
            res.update({n: cut(o) for n, o in zip(_NN_KEYS, outs[6:12])})
            k = 12
        rst = cut(outs[k])
        res["BG0"], res["CGM0"] = rst[0], rst[1]
        if nn:
            res.update({n: rst[2 + i] for i, n in enumerate(_TAIL_KEYS)})
        if cfg.persistent_state:
            res["state_f"], res["state_i"] = cut(outs[k + 1]), cut(outs[k + 2])
        return res

    return run


def make_sharded_pallas_rollout(
    cfg: PallasRolloutConfig,
    batch: int,
    mesh,
    axis: str = "dp",
    interpret: bool = False,
):
    """Multi-device fast path: the kernel under ``shard_map`` over a device
    mesh axis — each device runs its shard of the patient batch with zero
    inter-device communication during the rollout (the workload is
    embarrassingly parallel over patients, like the reference's process
    pool, sim_engine.py:65-76).  Each device passes its first global lane
    as ``lane0``, so every patient draws the same random stream it would
    draw in a single-device run: a sharded run equals the unsharded one.

    Supports every kernel configuration the single-device runner does,
    with the same ``run(packed_params, seed, reset_noise=, step_noise=,
    weights=, state=, init=, step0=)`` signature: 'nn' weights are
    replicated; state, noise planes and outputs are sharded over the
    batch axis.  ``batch`` is GLOBAL and must split evenly over the
    devices of ``axis``.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.shape[axis]
    if batch % n_dev:
        raise ValueError(
            f"global batch {batch} must divide into {n_dev} devices"
        )
    per = batch // n_dev
    inner = make_pallas_rollout(cfg, per, interpret=interpret)
    nn = cfg.controller == "nn"
    lanes = P(None, axis)

    # optional inputs in the order run() packs them
    rest_specs = []
    if cfg.exogenous_noise:
        rest_specs += [lanes, lanes]  # reset_noise, step_noise
    if nn:
        rest_specs += [P()]  # weights (replicated)
    if cfg.persistent_state:
        rest_specs += [lanes, lanes, P()]  # state_f, state_i, init

    def device_fn(packed, seed, step0, *rest):
        lane0 = jax.lax.axis_index(axis) * per
        kw = {}
        rest = list(rest)
        if cfg.exogenous_noise:
            kw["reset_noise"], kw["step_noise"] = rest.pop(0), rest.pop(0)
        if nn:
            kw["weights"] = rest.pop(0)
        if cfg.persistent_state:
            kw["state"] = (rest.pop(0), rest.pop(0))
            kw["init"] = rest.pop(0)
        return inner(packed, seed, step0=step0, lane0=lane0, **kw)

    out_specs = {k: lanes for k in _TRAJ_KEYS}
    out_specs["BG0"] = out_specs["CGM0"] = P(axis)
    if nn:
        out_specs.update({k: lanes for k in _NN_KEYS})
        out_specs.update({k: P(axis) for k in _TAIL_KEYS})
    if cfg.persistent_state:
        out_specs["state_f"] = out_specs["state_i"] = lanes

    sharded = shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(lanes, P(), P(), *rest_specs),
        out_specs=out_specs,
        check_vma=False,
    )

    def run(
        packed_params: jnp.ndarray,
        seed,
        reset_noise=None,
        step_noise=None,
        weights=None,
        state=None,
        init=None,
        step0=0,
    ) -> dict:
        rest = []
        if cfg.exogenous_noise:
            if reset_noise is None or step_noise is None:
                raise ValueError(
                    "exogenous_noise config needs reset_noise [2, B] and "
                    "step_noise [n_steps, B] (global lanes; sharded over "
                    "the batch axis like packed_params)"
                )
            rest += [
                jnp.asarray(reset_noise, jnp.float32),
                jnp.asarray(step_noise, jnp.float32),
            ]
        if nn:
            if weights is None:
                raise ValueError(
                    "'nn' config needs weights= (pack_policy_weights)"
                )
            rest.append(jnp.asarray(weights, jnp.float32))
        if cfg.persistent_state:
            if state is None:
                state = (
                    jnp.zeros((NS_F, batch), jnp.float32),
                    jnp.zeros((NS_I, batch), jnp.int32),
                )
            init_s = (
                jnp.int32(1) if init is None else jnp.asarray(init, jnp.int32)
            )
            rest += [state[0], state[1], init_s]
        elif init is not None:
            raise ValueError("init= only applies to persistent_state configs")
        return sharded(
            packed_params,
            jnp.asarray(seed, jnp.int32).reshape(()),
            jnp.asarray(step0, jnp.int32).reshape(()),
            *rest,
        )

    return run
