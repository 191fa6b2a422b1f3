"""Simulator law bands: distributional statistics of a cohort rollout and
the bands they must fall in.

These are properties of the simulated physiology, sensor and scenario, not
of the machine: a kernel or engine that clamps BG, drops meals or zeroes
the noise fails them (reference laws sensor/noise_gen.py:15-69,
scenario_gen.py:33-60).  The bench and chip_smoke.py gate every run they
time on them, so a fast wrong number is never reported.
"""
from __future__ import annotations

import jax.numpy as jnp


def law_stats(traj, sample_time: int = 3) -> dict:
    """{bg_mean, done_rate, resid_std, cho_per_day} of a rollout whose
    ``traj`` maps BG/CGM/CHO/done to arrays of one shape."""
    bg = jnp.asarray(traj["BG"])
    steps_per_day = 1440 // sample_time
    stats = {
        "bg_mean": jnp.mean(bg),
        "done_rate": jnp.mean(jnp.asarray(traj["done"]).astype(jnp.float32)),
        "resid_std": jnp.std(jnp.asarray(traj["CGM"]) - bg),
        "cho_per_day": jnp.mean(jnp.asarray(traj["CHO"]))
        * sample_time * steps_per_day,
    }
    return {k: float(v) for k, v in stats.items()}


# PID config (P=-1e-4, I=-1e-7), Dexcom, auto-reset, random scenario:
# centres from the kernel-vs-XLA cross-validation in BASELINE.md (BG mean
# 203.8, done rate 0.0080, CGM-BG residual std 11.47, CHO/day ~220 g).
PID_BANDS = dict(
    bg_mean=(170.0, 240.0), done_rate=(0.003, 0.020),
    resid_std=(8.0, 15.0), cho_per_day=(160.0, 280.0),
)

# The same PID config at the other sensors' sample times (GuardianRT 5
# min, Navigator 1 min): the noise-lattice cadence changes with them.
# Centres (B=1024, T=576): GuardianRT bg 207 / done 0.014 / resid 11.5 /
# cho 221; Navigator bg 195 / done 0.002 / resid 11.5 / cho 206-214.
SENSOR_BANDS = {
    "GuardianRT": dict(
        bg_mean=(175.0, 240.0), done_rate=(0.005, 0.030),
        resid_std=(8.0, 15.0), cho_per_day=(160.0, 280.0),
    ),
    "Navigator": dict(
        bg_mean=(165.0, 230.0), done_rate=(0.0005, 0.010),
        resid_std=(8.0, 15.0), cho_per_day=(160.0, 280.0),
    ),
}

# The reference's canonical cohort: 30 patients x 24 h, basal-bolus
# therapy, Dexcom, random scenario, no auto-reset (done_rate is then the
# share of steps outside the [70, 350] mg/dL done thresholds, mostly the
# hypoglycaemic tail of BB therapy: about 5% on both engines).  BASELINE.md
# records BG mean 138.9 / CHO 198.6 g at B=4096; 30 patients make the
# sample smaller, so the bands are wide.
BB_COHORT_BANDS = dict(
    bg_mean=(115.0, 170.0), done_rate=(0.0, 0.12),
    resid_std=(7.0, 16.0), cho_per_day=(130.0, 270.0),
)


def check_bands(stats: dict, bands: dict, where: str = "") -> None:
    """Raise AssertionError naming the first statistic outside its band."""
    for name, (lo, hi) in bands.items():
        value = stats[name]
        if not (lo <= value <= hi):
            raise AssertionError(
                f"law violation{' (' + where + ')' if where else ''}: "
                f"{name}={value:.4g} outside [{lo}, {hi}] — the run no "
                f"longer matches the cross-validated simulator laws"
            )
