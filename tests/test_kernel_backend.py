"""The rollout kernel's GPU route, checked on the CPU: it lowers to Triton
for CUDA in every configuration, the wrapper's block choice and lane
padding, the counter-based random streams, and the one function that
picks the route (ops/backend.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.models.uva_padova import basal_rate
from simglucose_tpu.ops import backend
from simglucose_tpu.ops.pallas_rollout import (
    NP_PLANES,
    PallasRolloutConfig,
    block_for,
    config_for_sensor,
    draw_bits,
    lane_keys,
    make_pallas_rollout,
    pack_params,
    round_half_even,
)

_CONFIGS = {
    "pid": dict(controller="pid"),
    "bb_meals": dict(controller="bb", deterministic=True,
                     det_meal_times=(3, 10), det_meal_amounts=(30.0, 20.0)),
    "exogenous": dict(controller="bb", deterministic=True,
                      exogenous_noise=True, autoreset=False),
    "static_guardian": dict(sensor="GuardianRT", controller="pid",
                            scenario_kind="static", autoreset=False,
                            det_meal_times=(3,), det_meal_amounts=(30.0,)),
    "nn_persistent": dict(controller="nn", persistent_state=True),
    "nn_residual_bb": dict(controller="nn", persistent_state=True,
                           nn_decoder="residual_bb", nn_sample_actions=False,
                           autoreset=False),
}


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_kernel_lowers_to_triton_for_cuda(name):
    """Every kernel configuration lowers through Pallas' Triton route for
    CUDA (cross-platform lowering needs no GPU) — with x64 on, as in the
    tests.  Catches primitives or shapes the route does not take before a
    chip ever sees them."""
    over = dict(_CONFIGS[name])
    sensor = over.pop("sensor", "Dexcom")
    T, B = 16, 256
    cfg = config_for_sensor(sensor, n_steps=T, **over)
    run = make_pallas_rollout(cfg, B)
    kw = {}
    if cfg.controller == "nn":
        kw["weights"] = jnp.zeros((32 + cfg.nn_hidden, cfg.nn_hidden))
    if cfg.exogenous_noise:
        kw["reset_noise"] = jnp.zeros((2, B))
        kw["step_noise"] = jnp.zeros((T, B))
    packed = jnp.zeros((NP_PLANES, B), jnp.float32)
    low = jax.jit(lambda p, s: run(p, s, **kw)).trace(packed, 0).lower(
        lowering_platforms=("cuda",)
    )
    text = low.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert f"simglucose_rollout_{cfg.controller}" in text


def test_block_for():
    """Programs are `block` patients wide; small cohorts shrink the block
    to the next power of two (never below 16)."""
    assert block_for(4096, 128) == 128
    assert block_for(30, 128) == 32
    assert block_for(3, 128) == 16
    assert block_for(100, 64) == 64
    for bad in (0, 48, 8):
        with pytest.raises(ValueError, match="power of two"):
            block_for(256, bad)


def _packed(names):
    _, params = make_env(names, batch=True, dtype=np.float32)
    return pack_params(params.patient, basal_rate(params.patient))


def test_padded_batch_matches_wider_run():
    """A batch that is not a multiple of the block is padded inside the
    wrapper and sliced back.  Random streams are keyed by the global lane,
    so the first 200 patients of a 256-patient stochastic run are the same
    values as a 200-patient run."""
    names = cohort_names(256)
    packed = _packed(names)
    cfg = PallasRolloutConfig(n_steps=6, controller="pid")
    full = make_pallas_rollout(cfg, 256, interpret=True)(packed, 9)
    part = make_pallas_rollout(cfg, 200, interpret=True)(packed[:, :200], 9)
    for k in ("BG", "CGM", "CHO", "insulin", "done"):
        assert part[k].shape == (6, 200)
        np.testing.assert_array_equal(np.asarray(part[k]),
                                      np.asarray(full[k])[:, :200], err_msg=k)
    np.testing.assert_array_equal(np.asarray(part["BG0"]),
                                  np.asarray(full["BG0"])[:200])


def test_block_size_does_not_change_results():
    """The in-kernel loop over steps runs per program; splitting the same
    lanes into 16-wide or 64-wide programs gives identical trajectories."""
    names = cohort_names(64)
    packed = _packed(names)
    out = [
        make_pallas_rollout(
            PallasRolloutConfig(n_steps=5, controller="pid", block=b), 64,
            interpret=True,
        )(packed, 4)
        for b in (16, 64)
    ]
    for k in ("BG", "CGM", "reward", "insulin"):
        np.testing.assert_array_equal(np.asarray(out[0][k]),
                                      np.asarray(out[1][k]), err_msg=k)


def test_random_streams_disjoint():
    """Streams of adjacent seeds, adjacent lanes and adjacent counters
    (steps / chunks) share no 32-bit draw beyond chance and are
    uncorrelated."""
    lanes = jnp.arange(4096, dtype=jnp.int32)
    k0 = lane_keys(jnp.int32(7), lanes)
    k1 = lane_keys(jnp.int32(8), lanes)
    assert len(np.unique(np.asarray(k0))) == 4096  # lane -> key bijective
    ctrs = jnp.arange(4096, dtype=jnp.uint32)
    streams = {
        "seed": (draw_bits(k0, jnp.uint32(64)), draw_bits(k1, jnp.uint32(64))),
        # one lane's draws over 4096 counters vs its neighbour's
        "lane": (draw_bits(k0[5], ctrs), draw_bits(k0[6], ctrs)),
        "counter": (draw_bits(k0, jnp.uint32(64)),
                    draw_bits(k0, jnp.uint32(65))),
        "chunk": (draw_bits(k0, jnp.uint32(64 * 480)),
                  draw_bits(k0, jnp.uint32(64 * 481))),
    }
    for name, (a, b) in streams.items():
        a, b = np.asarray(a), np.asarray(b)
        # 4096^2 / 2^32 ~ 0.004 expected coincidences
        assert len(np.intersect1d(a, b)) <= 2, name
        ua, ub = a / 2.0**32, b / 2.0**32
        assert abs(np.corrcoef(ua, ub)[0, 1]) < 0.06, name
        assert abs(ua.mean() - 0.5) < 0.02, name


def test_round_half_even_matches_jnp_round():
    """The kernel's rounding (the Triton route has no round primitive)
    equals jnp.round — ties to even — on pump- and meal-sized values."""
    x = np.concatenate([
        np.arange(-6.0, 6.0, 0.25),
        np.random.RandomState(0).uniform(-4e6, 4e6, 1000),
        np.arange(0.5, 200.5, 1.0),
    ]).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(round_half_even(jnp.asarray(x))),
        np.asarray(jnp.round(jnp.asarray(x))),
    )


def test_kernel_mode(monkeypatch):
    """One function picks the route: the interpreter only when the caller
    asked for it, the kernel on a GPU, the XLA engine elsewhere."""
    assert backend.kernel_mode(interpret=True) == backend.INTERPRET
    assert backend.kernel_mode() == backend.XLA  # this suite runs on CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.kernel_mode() == backend.KERNEL
    assert backend.kernel_mode(interpret=True) == backend.INTERPRET


def test_evaluate_policy_kernel_needs_gpu_or_interpret():
    """The kernel evaluator never interprets implicitly: on a CPU without
    interpret=True it raises."""
    from simglucose_tpu.rl.evaluate import evaluate_policy_kernel
    from simglucose_tpu.rl.policy import init_policy

    policy = init_policy(jax.random.PRNGKey(0), hidden=16, act="relu")
    with pytest.raises(ValueError, match="needs a compiled kernel"):
        evaluate_policy_kernel(policy, ["adolescent#001"], hours=0.1)
