"""Programmatic batch simulation: custom scenario, cohort, report
(capability parity: reference examples/advanced_tutorial.py)."""
from datetime import datetime, timedelta

from simglucose_tpu.sim import SimObj, batch_sim, simulate

# --- One-call cohort simulation (one compiled program) ----------------------
# Everything below runs as ONE compiled jit(vmap(scan)) program.
df = simulate(
    sim_time=timedelta(hours=24),
    patient_names=["adolescent#001", "adolescent#002", "adult#001"],
    controller="BB",
    scenario=[(7.0, 45.0), (12.0, 70.0), (18.0, 80.0)],  # (hour, grams)
    start_time=datetime(2018, 1, 1, 0, 0, 0),
    save_path="./results",
)
print(df.groupby(level=0).BG.describe())

# --- Familiar SimObj/batch_sim surface -------------------------------------
sim_objects = [
    SimObj(
        patient_name=name,
        controller="BB",
        sim_time=timedelta(hours=12),
        start_time=datetime(2018, 1, 1),
        seed=1,
    )
    for name in ("child#001", "child#002")
]
results = batch_sim(sim_objects, parallel=True)  # fused into one program
for r in results:
    print(r.BG.describe())
