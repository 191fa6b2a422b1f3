"""Fused PPO training: the actor rollout runs as ONE GPU kernel (env
physics + policy MLP + action sampling, state in registers,
simglucose_tpu/rl/fused.py); the learner stays in XLA and episodes persist
across iterations.  The fastest way to train a glucose controller at
cohort scale — the kernel rolls the closed loop tens of times faster than
the XLA-scan actor of examples/train_ppo.py (PERF.md has the H100
numbers).

Multi-chip: pass a mesh and the kernel fans out one-per-device with the
learner's gradient all-reduce inserted by GSPMD.

Reference analog: rllab DDPG training over the gym env
(reference: examples/run_rllab.py:1-43).
"""
import jax
import numpy as np

from simglucose_tpu.envs.build import cohort_names, make_env
from simglucose_tpu.models.uva_padova import basal_rate
from simglucose_tpu.ops.backend import XLA, kernel_mode
from simglucose_tpu.ops.pallas_rollout import pack_params
from simglucose_tpu.rl.fused import init_fused_state, make_fused_train_loop
from simglucose_tpu.rl.policy import init_policy
from simglucose_tpu.rl.ppo import PPOConfig, make_optimizer

B = 8192  # patients on one GPU
BLOCKS, ITERS_PER_BLOCK = 6, 100  # 600 iterations, one dispatch per block
HIDDEN = 64

# a GPU compiles the kernel; a CPU runs it in the Pallas interpreter,
# which is for correctness work, not speed — shrink
interpret = kernel_mode() == XLA
if interpret:
    B, BLOCKS, ITERS_PER_BLOCK = 128, 2, 2

_, params = make_env(cohort_names(B), batch=True, dtype=np.float32)
packed = pack_params(params.patient, basal_rate(params.patient))

key = jax.random.PRNGKey(0)
cfg = PPOConfig(
    rollout_steps=64, epochs=2, minibatches=4, ent_coef=0.01, lr=1e-3,
)
policy = init_policy(
    jax.random.fold_in(key, 1), hidden=HIDDEN, act="relu",  # the kernel trunk
    init_log_std=cfg.init_log_std, init_mu_bias=-2.2,  # safe cold start
)
ts = init_fused_state(policy, make_optimizer(cfg).init(policy), B, key)
# K train iterations per dispatch: scan them inside one program so the
# host dispatches once per block.  The dense neg-risk
# reward is the robust training objective (see tests/test_ppo.py notes).
loop = jax.jit(
    make_fused_train_loop(
        cfg, B, ITERS_PER_BLOCK, hidden=HIDDEN, interpret=interpret,
        reward_kind="neg_risk",
    ),
    donate_argnums=(1,),
)

for blk in range(BLOCKS):
    ts, m = loop(packed, ts)
    i = (blk + 1) * ITERS_PER_BLOCK
    print(
        f"iter {i:4d}  reward {float(m['reward_mean'][-1]):+.4f}  "
        f"done/step {float(m['done_frac'][-1]):.4f}  "
        f"entropy {float(m['entropy'][-1]):.3f}"
    )
