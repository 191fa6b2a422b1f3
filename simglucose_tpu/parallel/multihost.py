"""Multi-host orchestration: jax.distributed init + per-host result IO.

The reference's only multi-worker story is a single-machine process pool
gathering DataFrames (reference: simulation/sim_engine.py:65-76).  The
equivalent here spans hosts: one process per host, a global mesh over
all devices, and per-host IO over each host's addressable shard of the
patient batch (the analog of the reference's per-worker CSV writes,
sim_engine.py:44-49).

Single-process runs degrade gracefully: every helper works unchanged on one
host (then "global" == "local").
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence

import jax
import numpy as np

logger = logging.getLogger(__name__)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up jax.distributed (no-op on single-process runs with no
    coordinator).  Where a cluster environment provides them the arguments
    are auto-detected; pass them explicitly elsewhere (on a single GPU
    host, coordinator_address='localhost:<port>')."""
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except Exception as e:  # single-process / no cluster env
            logger.info("jax.distributed not initialized (%s); single host", e)
            return
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    logger.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def local_batch_slice(global_batch: int) -> slice:
    """This host's contiguous slice of a [global_batch] patient axis sharded
    over a dp mesh laid out process-major (jax.make_mesh default)."""
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)


def local_shard(tree):
    """Host-local numpy view of a sharded pytree's addressable rows (the
    per-worker result gathering analog).  Leaves come back with this host's
    shard of the leading axis."""

    def pull(a):
        if not hasattr(a, "addressable_shards"):
            return np.asarray(a)
        shards = list(a.addressable_shards)
        if len(shards) == 1:
            return np.asarray(shards[0].data)
        # find the sharded axis (the index slice that varies across shards)
        axis = 0
        for d, sl in enumerate(shards[0].index):
            if any(s.index[d] != sl for s in shards[1:]):
                axis = d
                break
        shards.sort(key=lambda s: s.index[axis].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], axis=axis)

    return jax.tree.map(pull, tree)


def save_local_results(
    tree,
    patient_names: Sequence[str],
    start_time,
    sample_time: int,
    save_path: str,
):
    """Write this host's patients to per-patient CSVs (every host writes its
    own shard — mirroring the reference's per-worker writes)."""
    import os

    from simglucose_tpu.analysis.report import cohort_frame

    reset_res, traj = tree
    sl = local_batch_slice(len(patient_names))
    names = list(patient_names)[sl]
    local = local_shard((reset_res, traj))
    df = cohort_frame(local[0], local[1], names, start_time, sample_time)
    os.makedirs(save_path, exist_ok=True)
    for name in names:
        df.loc[name].to_csv(os.path.join(save_path, f"{name}.csv"))
    return df
