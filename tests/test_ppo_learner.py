"""Invariants of the PPO learner (rl/ppo._ppo_loss / _update), the XLA
learner both trainers share: the clipped surrogate's boundary, the
epoch-0 policy ratio, and the data-parallel mesh against one device."""
import jax
import jax.numpy as jnp
import numpy as np

from simglucose_tpu.rl.policy import OBS_DIM, gaussian_logprob, init_policy, \
    policy_apply
from simglucose_tpu.rl.ppo import (
    PPOConfig,
    Transition,
    _ppo_loss,
    _update,
    make_optimizer,
)


def _batch(n=256, seed=0, shift=0.0):
    """A minibatch at the policy's own action log-probs (+ ``shift``)."""
    params = init_policy(jax.random.PRNGKey(1), hidden=16, act="relu")
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    obs = jax.random.normal(k[0], (n, OBS_DIM))
    raw = jax.random.normal(k[1], (n,))
    mu, log_std, _ = policy_apply(params, obs)
    logp = gaussian_logprob(mu, log_std, raw)
    adv = jax.random.normal(k[2], (n,))
    ret = jax.random.normal(k[3], (n,))
    return params, (obs, raw, logp - shift, adv, ret)


def test_epoch0_ratio_is_one():
    """At the rollout's own parameters the ratio is exactly 1, so the
    clipped and unclipped surrogates agree and pg_loss is -mean of the
    normalized advantages (zero)."""
    cfg = PPOConfig()
    params, mb = _batch()
    obs, raw, logp_old, adv, _ = mb
    mu, log_std, _ = policy_apply(params, obs)
    ratio = jnp.exp(gaussian_logprob(mu, log_std, raw) - logp_old)
    np.testing.assert_array_equal(np.asarray(ratio), 1.0)
    _, (pg, _, _) = _ppo_loss(cfg, params, mb, None)
    assert abs(float(pg)) < 1e-6


def test_clip_boundary_stops_policy_gradient():
    """Rows past the clip boundary on the side their advantage favours
    (ratio > 1 + eps with a positive normalized advantage, ratio < 1 - eps
    with a negative one) sit on the clipped branch: the policy-gradient
    term has zero gradient there, while ratios inside the band keep a
    nonzero gradient."""
    cfg = PPOConfig(clip_eps=0.2, vf_coef=0.0, ent_coef=0.0)

    def pg_grad(up, down):
        params, (obs, raw, logp, adv, ret) = _batch()
        pos = (adv - adv.mean()) > 0  # the sign of the normalized advantage
        logp_old = logp - jnp.where(pos, np.log(up), np.log(down))
        g, _ = jax.grad(
            lambda p: _ppo_loss(cfg, p, (obs, raw, logp_old, adv, ret), None),
            has_aux=True,
        )(params)
        return max(float(jnp.abs(x).max()) for x in jax.tree.leaves(g))

    assert pg_grad(1.5, 0.5) == 0.0  # all rows clipped
    assert pg_grad(1.1, 0.9) > 0.0  # all rows inside [0.8, 1.2]


def test_update_dp_mesh_matches_single_device():
    """_update with the batch sharded over the 8-device dp mesh reproduces
    the single-device update (GSPMD inserts the gradient all-reduce)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from simglucose_tpu.parallel.sharding import make_mesh, replicate

    T, B = 8, 64
    cfg = PPOConfig(rollout_steps=T, epochs=2, minibatches=2)
    params = init_policy(jax.random.PRNGKey(1), hidden=16, act="relu")
    k = jax.random.split(jax.random.PRNGKey(2), 5)
    tr = Transition(
        obs=jax.random.normal(k[0], (T, B, OBS_DIM)),
        raw_action=jax.random.normal(k[1], (T, B)),
        logp=jnp.full((T, B), -1.0),
        value=jnp.zeros((T, B)),
        reward=jnp.zeros((T, B)),
        done=jnp.zeros((T, B), bool),
    )
    advs = jax.random.normal(k[2], (T, B))
    rets = jax.random.normal(k[3], (T, B))
    opt = make_optimizer(cfg)

    def run(mesh, tr, advs, rets, params):
        return jax.jit(lambda p, o, t, a, r: _update(
            cfg, opt, p, o, t, a, r, k[4], mesh))(
            params, opt.init(params), tr, advs, rets)

    ref = run(None, tr, advs, rets, params)
    mesh = make_mesh(dp=8, tp=1)
    shard = lambda a: jax.device_put(
        a, NamedSharding(mesh, P(None, "dp") if a.ndim >= 2 else P()))
    with mesh:
        got = run(mesh, jax.tree.map(shard, tr), shard(advs), shard(rets),
                  replicate(params, mesh))
    for a, b in zip(jax.tree.leaves(ref[0]), jax.tree.leaves(got[0])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
