"""Population-scale cohort simulation on the rollout-kernel engine.

Runs 4096 virtual patients for a simulated day (~2M env steps, ~6M patient
minutes) in milliseconds of device time on one GPU (plus the kernel's
one-off compile) — the high-throughput analog of the reference's batch_sim over a process pool
(reference: simulation/sim_engine.py:65-76).  The ``engine='pallas'``
fast path supports BB/PID controllers with random daily meal scenarios;
anything else (custom controllers/rewards/scenarios) runs on the general
``engine='xla'`` path.
"""
from datetime import timedelta

from simglucose_tpu.envs.build import cohort_names
from simglucose_tpu.sim import simulate

df = simulate(
    sim_time=timedelta(hours=24),
    patient_names=cohort_names(4096),  # 30 archetypes cycled to 4096
    controller="BB",
    scenario_seed=7,
    engine="pallas",  # needs a GPU; 'auto' takes the XLA engine elsewhere
)

bg = df["BG"].to_numpy()
tir = ((bg >= 70) & (bg <= 180)).mean() * 100
print(f"cohort: {bg.size} samples; BG mean {bg.mean():.1f} mg/dL; "
      f"time-in-[70,180] {tir:.1f}%")
