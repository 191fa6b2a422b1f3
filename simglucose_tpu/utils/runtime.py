"""Process setup shared by the command-line entry points (bench.py,
chip_smoke.py, tools/): JAX's persistent compile cache and a record of the
device a measurement ran on."""
from __future__ import annotations

import os
import subprocess

import jax

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """Where compiled programs are cached: ``JAX_COMPILATION_CACHE_DIR``
    when set (JAX reads it itself), else ``<checkout>/.jax_cache``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def use_compile_cache() -> str:
    """Turn on JAX's persistent compile cache.  With
    ``JAX_COMPILATION_CACHE_DIR`` set nothing is set in code; otherwise the
    cache lives at the fixed ``<checkout>/.jax_cache`` (a fixed path, so a
    later process finds what an earlier one compiled)."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    return compile_cache_dir()


def gpu_name_and_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``name, power.limit`` per card, one line each), or why it could not
    be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out


def device_record() -> dict:
    """{platform, kind, count} of the default JAX backend's devices."""
    d = jax.devices()
    return {
        "platform": d[0].platform,
        "kind": d[0].device_kind,
        "count": len(d),
    }
