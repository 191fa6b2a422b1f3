"""Where a rollout kernel runs: the one place that maps the JAX backend to
an execution route for the Pallas kernels (ops/pallas_rollout.py)."""
from __future__ import annotations

import jax

KERNEL = "kernel"  # the compiled Triton kernel (GPU)
INTERPRET = "interpret"  # the Pallas interpreter (tests, on request only)
XLA = "xla"  # no kernel: the plain XLA engine


def kernel_mode(interpret: bool = False) -> str:
    """The route for a kernel call.

    ``interpret=True`` (the caller's explicit request) -> 'interpret';
    otherwise 'kernel' on a GPU backend and 'xla' anywhere else.  Nothing
    falls back to the interpreter implicitly: a CPU run without
    ``interpret=True`` takes the XLA engine or, where the caller demanded
    the kernel, fails."""
    if interpret:
        return INTERPRET
    if jax.default_backend() == "gpu":
        return KERNEL
    return XLA
