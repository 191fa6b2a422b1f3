"""chip_smoke.py's contract off the card (it refuses to run without a GPU
and runs exactly its phases) and the compile-cache placement the entry
points share (simglucose_tpu/utils/runtime.py)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, SMOKE if cwd == ROOT else "chip_smoke.py", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    """No GPU: non-zero exit, and no result line on stdout."""
    out = _run([], ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding only chip_smoke.py (no program) it fails."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run([], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("four", [False, True])
def test_chip_smoke_phase_selection(monkeypatch, capsys, four):
    """--four-cards runs the multi-device phase and nothing else, and its
    last line reports the four devices; without it, the five one-card
    phases run in order."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    import simglucose_tpu.utils.runtime as rt

    count = 4 if four else 1
    monkeypatch.setattr(rt, "device_record", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count,
    })
    ran = []
    names = ("phase_golden", "phase_cohort", "phase_rollout",
             "phase_training", "phase_eval", "phase_four_cards")
    for n in names:
        monkeypatch.setattr(
            chip_smoke, n, lambda res, n=n: ran.append(n), raising=True
        )
    assert chip_smoke.main(["--four-cards"] if four else []) == 0
    assert ran == (["phase_four_cards"] if four else list(names[:5]))
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count,
    }}


def test_chip_smoke_four_cards_needs_four(monkeypatch):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    import simglucose_tpu.utils.runtime as rt

    monkeypatch.setattr(rt, "device_record", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
    })
    assert chip_smoke.main(["--four-cards"]) != 0


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it and nothing is set in
    code.  Unset: the fixed <checkout>/.jax_cache."""
    import jax

    from simglucose_tpu.utils import runtime

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
        assert runtime.use_compile_cache() == want
        assert calls == [("jax_compilation_cache_dir", want)]
    else:
        d = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
        assert runtime.use_compile_cache() == d
        assert calls == []


def test_main_path_needs_no_pandas_matplotlib_or_gymnasium():
    """chip_smoke's path — simulate_arrays, the trainers, the evaluators —
    imports only what the GPU machine is sure to have: with pandas,
    matplotlib and gymnasium made unimportable, the modules import and a
    small cohort runs to arrays."""
    code = """
import sys
for m in ("pandas", "matplotlib", "gymnasium"):
    sys.modules[m] = None
sys.path.insert(0, %r)
import jax
jax.config.update("jax_platforms", "cpu")
import chip_smoke
import simglucose_tpu.rl.evaluate, simglucose_tpu.rl.fused
import simglucose_tpu.utils.checkpoint, simglucose_tpu.compat.scenario
from datetime import timedelta
from simglucose_tpu.sim.engine import simulate_arrays
arr = simulate_arrays(
    sim_time=timedelta(minutes=9), patient_names=["adult#001", "child#002"],
    controller="BB", engine="xla")
assert arr.traj.BG.shape == (3, 2)
print("OK")
""" % ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("OK")
