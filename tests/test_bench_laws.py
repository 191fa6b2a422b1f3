"""The law-assertion gate bench.py and chip_smoke.py share
(simglucose_tpu/analysis/laws.py): a kernel regression that clamps BG,
drops meals, or zeroes the noise must FAIL the run instead of posting a
fast wrong headline (the distributional invariants cross-validated in
BASELINE.md; reference laws sensor/noise_gen.py:15-69,
scenario_gen.py:33-60)."""
import numpy as np
import pytest

from simglucose_tpu.analysis.laws import PID_BANDS, check_bands, law_stats


def _good_stats():
    # the round-1 cross-validated PID-config values (BASELINE.md)
    return {
        "bg_mean": 203.8,
        "done_rate": 0.0080,
        "resid_std": 11.47,
        "cho_per_day": 220.0,
    }


def test_check_laws_accepts_reference_stats():
    check_bands(_good_stats(), PID_BANDS)


@pytest.mark.parametrize(
    "key,bad",
    [
        ("bg_mean", 39.0),  # BG clamped to the sensor floor
        ("bg_mean", 400.0),  # runaway hyperglycemia
        ("done_rate", 0.0),  # terminations vanished
        ("resid_std", 0.0),  # noise zeroed
        ("resid_std", 50.0),  # noise law broken
        ("cho_per_day", 0.0),  # meals dropped
    ],
)
def test_check_laws_rejects_violations(key, bad):
    stats = _good_stats()
    stats[key] = bad
    with pytest.raises(AssertionError, match="law violation"):
        check_bands(stats, PID_BANDS)


def test_law_stats_computation():
    """law_stats computes the right quantities from a traj dict."""
    T, B = 16, 8
    rng = np.random.RandomState(0)
    bg = 200.0 + rng.standard_normal((T, B)).astype(np.float32)
    noise = rng.standard_normal((T, B)).astype(np.float32) * 11.5
    traj = {
        "BG": bg,
        "CGM": bg + noise,
        "done": np.zeros((T, B), bool),
        "CHO": np.full((T, B), 220.0 / 1440.0, np.float32),
    }
    stats = law_stats(traj, 3)
    assert abs(stats["bg_mean"] - 200.0) < 1.0
    assert abs(stats["resid_std"] - 11.5) < 2.0
    assert stats["done_rate"] == 0.0
    assert abs(stats["cho_per_day"] - 220.0) < 1e-3
