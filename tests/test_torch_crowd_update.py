"""One `_update_minibatch` of the port's crowd agent (AMPSeptCNNNet: the
conv encoder over the 8×8×3 velocity-map image and the people pointnet)
against emloco_tpu's, from the same parameters and a fresh optimizer state
with JAX's dropout masks: the loss terms, the conv, pointnet and MLP
gradients and the step, to the tolerances of tests/test_torch_train.py.
The world, the networks and their parameters are
tests/test_torch_crowd_agent.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np

from emloco_tpu.envs import observations as jobs
from emloco_tpu_torch import convert
from test_torch_crowd_agent import (_agents, nets, np_tree, t_,  # noqa: F401
                                    to_flax, world)
from test_torch_train import (DEMO, HALF, OPTAX_B1, assert_update_close,
                              minibatch)


def test_update_minibatch_matches_jax(world, nets):
    """One crowd update from JAX's parameters and a fresh optimizer state,
    with JAX's dropout masks: the conv, pointnet and MLP gradients and the
    step (tests/test_torch_train.py's comparison)."""
    jagent, agent = _agents(world, network="sept_cnn", amp_replay_size=16)
    jcfg = world["jcfg"]
    obs_dim, amp_dim = world["env"].obs_dim, agent.amp_dim
    p0 = nets["sept_cnn", False][1]
    o0 = jagent.tx.init(p0)

    def actor(o):
        mu, sigma = jagent.net.apply(p0, jnp.asarray(o),
                                     method=jagent.net.actor)
        return np.asarray(mu), np.asarray(sigma)

    key = jax.random.PRNGKey(3)
    mb, demo, replay = minibatch(obs_dim, amp_dim, actor, seed=5)
    p1, o1, jm = jax.jit(jagent._update_minibatch)(
        p0, o0, {k: jnp.asarray(v) for k, v in mb.items()},
        jnp.asarray(demo), jnp.asarray(replay), key)
    assert float(jm["nonfinite_grad"]) == 0.0
    masks = tuple(
        t_(jobs.amp_dropout_mask(k, r, jcfg.num_amp_obs_steps,
                                 jcfg.amp_obs_per_step,
                                 jagent.cfg.amp_dropout_rate))
        for k, r in zip(jax.random.split(key, 3), (HALF, HALF, DEMO)))
    tparams = convert.agent_state_dict(np_tree(p0))
    assert any(k.startswith("cnn.") for k in tparams)
    assert any(k.startswith("point_net.") for k in tparams)
    tmb = {k: t_(v) for k, v in mb.items()}
    _, _, tg = agent._loss_and_grads(tparams, tmb, t_(demo), t_(replay),
                                     masks)
    tp1, _, tm = agent._update_minibatch(tparams, agent.tx.init(tparams),
                                         tmb, t_(demo), t_(replay), masks)
    assert float(tm["nonfinite_grad"]) == 0.0
    m0 = convert.adam_state(np_tree(o0), "cpu").mu
    m1 = convert.adam_state(np_tree(o1), "cpu").mu
    jg = {k: (m1[k].double() - OPTAX_B1 * m0[k].double()) / (1 - OPTAX_B1)
          for k in m1}
    step_ref = convert.agent_state_dict(np_tree(jax.jit(
        lambda g, o, p: jax.tree.map(
            lambda a, b: a + b, p, jagent.tx.update(g, o, p)[0]))(
            to_flax(tg), o0, p0)))
    assert_update_close((tparams, tp1, agent.tx.clip(tg), tm),
                        (tparams, convert.agent_state_dict(np_tree(p1)), jg,
                         dict(jm)), step_ref, jagent.cfg.lr)
