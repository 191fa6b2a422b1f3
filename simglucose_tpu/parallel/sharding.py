"""Device-mesh sharding for cohort-scale simulation and training.

The reference's only parallelism is an embarrassingly-parallel process pool
over patients (reference: simulation/sim_engine.py:65-76).  The equivalent
here shards the patient batch over a ``jax.sharding.Mesh``:

  * ``dp`` axis — patients (pure data parallel; zero communication during
    rollout, collectives only for metric reductions / learner gradients)
  * ``tp`` axis — optional tensor parallelism for the RL policy/value
    networks (hidden dimension sharded; XLA inserts the all-reduces)

Everything routes through ``jax.jit`` with explicit ``NamedSharding``
constraints — XLA hands the collectives to NCCL on GPUs.  Multi-host: the same code
runs under ``jax.distributed`` initialization; ``jax.make_mesh`` spans all
processes' devices and per-host IO uses addressable shards
(:func:`gather_to_host`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    dp: Optional[int] = None, tp: int = 1, devices: Optional[Sequence] = None
) -> Mesh:
    """Build a ('dp','tp') mesh.  Defaults: all devices on the dp axis."""
    devices = list(devices if devices is not None else jax.devices())
    if dp is None:
        dp = len(devices) // tp
    if dp * tp != len(devices):
        raise ValueError(f"dp*tp={dp*tp} != n_devices={len(devices)}")
    dev_array = np.asarray(devices).reshape(dp, tp)
    return Mesh(dev_array, axis_names=("dp", "tp"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (patient) axis over dp, replicate over tp."""
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(tree, mesh: Mesh):
    """Place a batched pytree with its leading axis sharded over dp.

    Every array leaf must have a leading batch axis divisible by the dp
    size (scalars are replicated).
    """
    sb = batch_sharding(mesh)
    rep = replicated(mesh)

    def place(a):
        a = jnp.asarray(a)
        return jax.device_put(a, sb if a.ndim >= 1 else rep)

    return jax.tree.map(place, tree)


def replicate(tree, mesh: Mesh):
    rep = replicated(mesh)
    return jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), rep), tree)


def gather_to_host(tree):
    """Fetch a (possibly sharded) pytree to host numpy — the analog of the
    reference's per-worker result gathering (sim_engine.py:69).  On
    multi-host runs, use jax.experimental.multihost_utils instead for
    cross-process gathers; this fetches addressable data."""
    return jax.tree.map(lambda a: np.asarray(jax.device_get(a)), tree)
