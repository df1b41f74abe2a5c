"""Work of the crowd configuration's network and observation, from shapes.

Flops (as `networks.py` counts them, as the algorithms need them): the
task embedding once for the actor and the critic. A conv forward is
2·rows·H'·W'·C_in·C_out·9; backward, the weight's gradient always and the
input's past the first conv (the image depends on no parameter). The
pointnet is a chain over rows·k points; the projection and every MLP a
chain. Biases, ReLUs, padding and the max-pool are not counted.

Bytes (the least the crowd observation can move, float32): its output
written once and its inputs read once. Per row of the velocity map: 3·P
out; in the head pivot (3), the root rotation (4), the root pivot (3,
also the sensor's centre and the person's stamp) and the root velocity
(3). Per call: the sensor grid (P·2) and the heightfield (H·W). Per row of
the crowd observation: 165 out; in the 10 group joints' pivots (30, the
root's among them), the root velocity (3) and rotation (4).
"""
from __future__ import annotations

from .networks import chain

VM_IN_PER_ROW = 3 + 4 + 3 + 3
GROUP_IN_PER_ROW = 10 * 3 + 3 + 4


def conv_layers(d: dict) -> list:
    """(out width, C_in, C_out) of each conv."""
    w, c, out = d["sensor_res"], d["sensor_channels"], []
    for f in d["cnn_features"]:
        w = -(-w // 2)
        out.append((w, c, f))
        c = f
    return out


def conv_encoder(d: dict, rows: int, backward: bool = False) -> int:
    """The convs and the ReLU projection to the task embedding's width."""
    layers = conv_layers(d)
    fwd = [2 * rows * w * w * ci * co * 9 for w, ci, co in layers]
    f = sum(fwd)
    if backward:
        f += sum(fwd) + sum(fwd[1:])
    w, _, co = layers[-1]
    proj = [w * w * co, d["task_units"][-1]]
    return f + chain(rows, proj, backward, input_grad=True)


def pointnet(d: dict, rows: int, backward: bool = False) -> int:
    dims = [d["people_obs"] // d["top_k"], *d["pointnet_units"]]
    return chain(rows * d["top_k"], dims, backward)


def _task_mlp(d: dict):
    img = d["sensor_res"] ** 2 * d["sensor_channels"]
    return [d["task_obs"] - d["people_obs"] - img, *d["task_units"]]


def embedding(d: dict, rows: int, backward: bool = False) -> int:
    """The task MLP, the conv encoder and the pointnet."""
    return (chain(rows, _task_mlp(d), backward) + conv_encoder(d, rows,
                                                               backward)
            + pointnet(d, rows, backward))


def _heads(d: dict):
    x = d["self_obs"] + 2 * d["task_units"][-1] + d["pointnet_units"][-1]
    actor = [x, *d["mlp_units"], d["actions"]]
    critic = [x, *d["mlp_units"], 1]
    disc = [d["amp_obs"], *d["disc_units"], 1]
    tv = [d["traj_obs"], *d["value_units"], 1]
    return actor, critic, disc, tv


def policy_minibatch(d: dict, rows: int, half: int, demo: int,
                     sym: bool = True) -> int:
    """`networks.policy_minibatch` with the crowd's embedding."""
    actor, critic, disc, tv = _heads(d)
    agent = min(half, rows) + half
    f = (embedding(d, rows, True) + chain(rows, actor, True, True)
         + chain(rows, critic, True, True) + chain(rows, tv, True)
         + chain(agent, disc, True) + chain(demo, disc, True))
    r1 = chain(demo, disc)
    top = 2 * demo * disc[-2] * disc[-1]
    f += r1 + 2 * r1 - top
    if sym:
        f += embedding(d, rows, True) + chain(rows, actor, True, True)
    return f


def policy_rollout_step(d: dict, envs: int) -> int:
    actor, critic, _, _ = _heads(d)
    return embedding(d, envs) + chain(envs, actor) + chain(envs, critic)


def policy_prepare(d: dict, envs: int, horizon: int) -> int:
    _, critic, disc, _ = _heads(d)
    return (chain(envs * horizon, disc) + embedding(d, envs)
            + chain(envs, critic))


def velocity_map_bytes(rows: int, calls: int, points: int,
                       terrain_cells: int) -> int:
    return 4 * (rows * (3 * points + VM_IN_PER_ROW)
                + calls * (2 * points + terrain_cells))


def group_obs_bytes(rows: int, people_obs: int) -> int:
    return 4 * rows * (people_obs + GROUP_IN_PER_ROW)
