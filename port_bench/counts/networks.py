"""Flops of the networks' GEMMs, forward and backward, as the algorithms
need them: 2·rows·in·out a linear layer forward; backward, the weight's
gradient always and the input's where the input depends on a parameter.
Elementwise work, norms and softmaxes are not counted.
"""
from __future__ import annotations


def chain(rows: int, dims, backward: bool = False,
          input_grad: bool = False, weight_grad: bool = True) -> int:
    """A chain of linear layers dims[0] → dims[1] → … on `rows` rows."""
    f = sum(2 * rows * a * b for a, b in zip(dims, dims[1:]))
    if not backward:
        return f
    first = 2 * rows * dims[0] * dims[1]
    return (f + (f if weight_grad else 0)
            + (f if input_grad else f - first))


def _policy_dims(d: dict):
    emb = d["task_units"][-1]
    task = [d["task_obs"], *d["task_units"]]
    actor = [d["self_obs"] + emb, *d["mlp_units"], d["actions"]]
    critic = [d["self_obs"] + emb, *d["mlp_units"], 1]
    disc = [d["amp_obs"], *d["disc_units"], 1]
    tv = [d["traj_obs"], *d["value_units"], 1]
    return task, actor, critic, disc, tv


def policy_minibatch(d: dict, rows: int, half: int, demo: int,
                     sym: bool = True) -> int:
    """One PPO + AMP minibatch: forward and backward of every head, the
    discriminator on the agent (rollout ∪ replay) and demo rows, and the R1
    penalty's input gradient with its own backward."""
    task, actor, critic, disc, tv = _policy_dims(d)
    agent = min(half, rows) + half
    f = (chain(rows, task, True) + chain(rows, actor, True, True)
         + chain(rows, critic, True, True) + chain(rows, tv, True)
         + chain(agent, disc, True) + chain(demo, disc, True))
    # R1: the input gradient through the disc, then its backward: the
    # gradients of each of its products by both operands, but the top
    # layer's ones
    r1 = chain(demo, disc)
    top = 2 * demo * disc[-2] * disc[-1]
    f += r1 + 2 * r1 - top
    if sym:
        f += chain(rows, task, True) + chain(rows, actor, True, True)
    return f


def policy_rollout_step(d: dict, envs: int) -> int:
    """The actor and critic on one control step's obs (the task MLP once)."""
    task, actor, critic, _, _ = _policy_dims(d)
    return chain(envs, task) + chain(envs, actor) + chain(envs, critic)


def policy_prepare(d: dict, envs: int, horizon: int) -> int:
    """The disc reward of the epoch's AMP windows and the last value."""
    task, _, critic, disc, _ = _policy_dims(d)
    return (chain(envs * horizon, disc) + chain(envs, task)
            + chain(envs, critic))


def policy_actor_step(d: dict, envs: int) -> int:
    task, actor, _, _, _ = _policy_dims(d)
    return chain(envs, task) + chain(envs, actor)


def disc_forward(d: dict, rows: int) -> int:
    return chain(rows, _policy_dims(d)[3])


def valuenet_dims(num_waypoints: int = 13):
    i = 2 * num_waypoints + 72 + 2
    return [i, i // 2 - 1, (i // 2 - 1) // 2, 1]


def valuenet_step(rows: int, num_waypoints: int = 13) -> int:
    return chain(rows, valuenet_dims(num_waypoints), True)


def transmotion_step(c: dict, batch: int, people: int) -> int:
    """One train step: the five input projections, the local encoder over
    each person's 453 tokens, the global one over the people's 21
    trajectory tokens, the heads on the primary's 21, and the EmLoco loss's
    LocoVal net (frozen: input gradients only), forward and backward."""
    D, FF, H, M = c["nhid"], c["dim_ff"], c["nhead"], c["nmode"]
    B, N = batch, people
    obs, tot, j3, j2 = 9, 21, 24, 22
    S = tot + obs * (3 + j3 + j2 - 1)              # 453
    f = (chain(B * tot * N, [2, D], True) + chain(B * obs * N, [4, D], True)
         + chain(B * obs * N, [4, D], True)
         + chain(B * obs * N * j3, [3, D], True)
         + chain(B * obs * N * j2, [2, D], True))

    def layer(seqs, s):
        proj = 4 * 2 * seqs * s * D * D
        attn = 2 * 2 * seqs * s * s * D
        ff = 2 * 2 * seqs * s * D * FF
        return 3 * (proj + attn + ff)               # forward, two grads
    f += c["nlayers_local"] * layer(B * N, S)
    f += c["nlayers_global"] * layer(B, N * tot)
    f += chain(B * tot, [D, 2 * M], True, True)
    v = valuenet_dims(12 + 1)
    f += chain(B * M, v) * 2                        # forward, input grads
    del H
    return f
