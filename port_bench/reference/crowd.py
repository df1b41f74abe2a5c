"""PACER's crowd-aware pedestrian policy, plain PyTorch: the crowd
observation and the velocity map with the people stamped in, their
left/right mirror, the conv encoder and the people pointnet beside the
task MLP, and the PPO + AMP minibatch loss and update through them.

The observation (EmLoco's PACER, humanoid_pedestrain_terrain.py
compute_group_observation :1613-1666 and the velocity-map sensor): the
envs form groups of `group` consecutive envs. Each env finds the `TOP_K`
nearest others of its group by the distance of their root pivots (in 3-d
for the crowd observation, in the ground plane for the stamping); a
person beyond `MAX_DIST` reads zero. The crowd observation holds, in the
observer's heading frame, each person's `GROUP_JOINTS` pivots relative to
the observer's root, all k position blocks first, then their root COM
velocities. The 32 × 32 square sensor around the head reads [relative
height, vx, vy]: each of the k people is a world-axis `FOOTPRINT` box
around its root; a point inside one reads the ground raised by
`PERSON_HEIGHT` and the velocity of the nearest covering person, then
every point [ch − h, v − v_ego] with v rotated into the heading frame
(an uncovered point: −v_ego).

The network (amp_network_sept_cnn_builder.py :17-164 with the pointnet of
amp_network_sept_builder.py :14-181): the sensor image goes through three
stride-2 3×3 convs (16, 32, 32, ReLU, XLA's "SAME" padding), flattened in
(H, W, C) order, and a ReLU projection to the task embedding's width; the
task MLP reads the trajectory samples; the pointnet (32, 64, 64, ReLU
between its layers, none after the last) reads each person's [10 joints ·
3 | root velocity] and is max-pooled over the people. The embedding
[task MLP | conv projection | pointnet] beside the self observation feeds
the actor and critic of `policy.py`; the discriminator and the task-value
head are `policy.py`'s.

Departures from the published description, each the port's: the padding
is XLA's "SAME" (the odd pixel on the high side), as the JAX package
builds the convs; the published PyTorch builder's padding is not checked
here. A group too small for k people pads the missing ones with zeros
after the present ones.

The max over the people: `amax`, whose gradient splits evenly among tied
entries, where the program routes a tie to one entry (`max(-2).values`).
Ties are exact only between identical points (the zero-padded people of a
small group, whose normalized rows are equal), and identical points get
identical per-point weight gradients, so the weight gradients agree under
either rule; only the gradient by each tied input differs, and no
parameter depends on that.

Float32 as the configuration states; the check runs it with
`fp32_precision = "ieee"` for matmul and cuDNN conv (`pacer._precision`),
the control in TF32. Nothing of the program is imported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import humanoid, optim, policy
from .world import NAMES

GROUP_JOINTS = tuple(NAMES.index(n) for n in (
    "Pelvis", "L_Hip", "R_Hip", "Torso", "L_Ankle", "R_Ankle", "L_Elbow",
    "R_Elbow", "L_Hand", "R_Hand"))
TOP_K = 5
MAX_DIST = 10.0
FOOTPRINT = (0.25, 0.5)            # half-widths along world x and y, m
PERSON_HEIGHT = 1.7


def _twin(n: str) -> str:
    if n.startswith("L_"):
        return "R_" + n[2:]
    if n.startswith("R_"):
        return "L_" + n[2:]
    return n


MIRROR_BODY = tuple(NAMES.index(_twin(n)) for n in NAMES)


# --- the crowd observation ---------------------------------------------------

def neighbours(x, group: int, k: int):
    """Each env's k nearest others in its group of `group` consecutive
    envs, nearest first, by the norm of the differences of the rows of x:
    (distances (N, k), flat env indices (N, k))."""
    N = x.shape[0]
    G = N // group
    g = x.reshape(G, group, -1)
    dist = torch.linalg.norm(g[:, :, None] - g[:, None], dim=-1)
    self_ = torch.eye(group, dtype=torch.bool, device=x.device)[None]
    dist = dist.masked_fill(self_, math.inf)
    order = torch.argsort(dist, dim=-1, stable=True)[..., :k]
    d = torch.gather(dist, -1, order)
    base = torch.arange(G, device=x.device)[:, None, None] * group
    return d.reshape(N, k), (order + base).reshape(N, k)


def crowd_obs(pos, v_root, root, root_rot, group: int):
    """The crowd observation (N, TOP_K·33): `pos` (N, 24, 3) every env's
    body pivots and `v_root` (N, 3) its root COM velocity (the people);
    `root`, `root_rot` the observer's root pivot and rotation."""
    N = pos.shape[0]
    k = min(TOP_K, group - 1)
    dist, idx = neighbours(pos[:, 0], group, k)
    hq = humanoid.heading_inv(root_rot)
    joints = pos[idx][:, :, list(GROUP_JOINTS)] - root[:, None, None]
    local = humanoid.rot(hq[:, None, None], joints)        # (N, k, 10, 3)
    vel = humanoid.rot(hq[:, None], v_root[idx])           # (N, k, 3)
    near = (dist <= MAX_DIST).to(pos.dtype)
    local = local * near[..., None, None]
    vel = vel * near[..., None]
    pad = TOP_K - k
    z = pos.new_zeros
    return torch.cat([local.reshape(N, -1), z((N, pad * 3 * len(
        GROUP_JOINTS))), vel.reshape(N, -1), z((N, pad * 3))], -1)


def sensor_points(head, root_rot, env: dict):
    """The square sensor's points in the world, (N, P) x and y: the grid
    turned by the heading and centred on the head."""
    grid = humanoid.sensor_grid(env["sensor_extent"], env["sensor_res"],
                                head.device).to(head.dtype)
    return _around(grid, humanoid.heading(root_rot), head)


def _around(grid, yaw, o):
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    gx, gy = grid[:, 0][None], grid[:, 1][None]
    return c * gx - s * gy + o[:, 0:1], s * gx + c * gy + o[:, 1:2]


def stamp(px, py, xy, v_root, group: int):
    """The people stamped onto the sensor points (px, py) (N, P): (covered
    (N, P) bool, the covering person's world velocity (N, P, 2), zero where
    none covers). `xy` (N, 2) every env's root pivot in the ground plane,
    `v_root` (N, 3) its root COM velocity."""
    k = min(TOP_K, group - 1)
    dist, idx = neighbours(xy, group, k)
    nxy, nv = xy[idx], v_root[idx][..., :2]                # (N, k, ·)
    dx = px[:, :, None] - nxy[:, None, :, 0]
    dy = py[:, :, None] - nxy[:, None, :, 1]
    inside = ((dx.abs() <= FOOTPRINT[0]) & (dy.abs() <= FOOTPRINT[1])
              & (dist <= MAX_DIST)[:, None])
    covered = inside.any(-1)
    d2 = torch.where(inside, dx * dx + dy * dy, math.inf)
    j = d2.argmin(-1)                                      # (N, P)
    v = torch.gather(nv, 1, j[..., None].expand(-1, -1, 2))
    return covered, torch.where(covered[..., None], v, 0.0)


def stamped_share(pos, root_rot, v_root, group: int, env: dict) -> float:
    """The share of envs with at least one stamped sensor point, every env
    observing from its own pose (`pos` (N, 24, 3) pivots)."""
    px, py = sensor_points(pos[:, NAMES.index("Head")], root_rot, env)
    covered, _ = stamp(px, py, pos[:, 0, :2], v_root, group)
    return float(covered.any(-1).float().mean())


def velocity_map(ground, head, root, root_rot, v_ego, xy, v_root,
                 group: int, env: dict):
    """The velocity-map sensor with the people stamped in, (N, P·3),
    channel innermost."""
    px, py = sensor_points(head, root_rot, env)
    h = ground.low(px, py)
    covered, v = stamp(px, py, xy, v_root, group)
    h = h + PERSON_HEIGHT * covered
    yaw = humanoid.heading(root_rot)
    centre = humanoid.sensor_grid(0.15, 3, head.device).to(head.dtype)
    ch = ground.low(*_around(centre, yaw, root)).mean(-1, keepdim=True)
    h_obs = torch.clamp(ch - h, -3.0, 3.0) * env["height_meas_scale"]
    rel = v - v_ego[:, None, :2]
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    vx = c * rel[..., 0] + s * rel[..., 1]
    vy = -s * rel[..., 0] + c * rel[..., 1]
    return torch.stack([h_obs, vx, vy], -1).reshape(h.shape[0], -1)


def observe(b, ground, s, verts, progress, env: dict, people=None):
    """[self obs | trajectory samples | velocity map | crowd] of the state
    `s`; `people` (default `s`) the state the others are read from (the
    program observes after its auto-reset, so a person whose episode ended
    has moved to its fresh spawn)."""
    people = s if people is None else people
    P = env["sensor_res"] ** 2
    # the self obs and the trajectory samples; its height map is dropped
    base = humanoid.observe(b, ground, s, verts, progress, env)[:, :-P]
    pos, grot, _, _ = humanoid.pivot_frame(b, s)
    others, _, _, _ = humanoid.pivot_frame(b, people)
    v_root = people["body_v"][:, 0]
    root, root_rot = pos[:, 0], grot[:, 0]
    g = env["group_size"]
    vm = velocity_map(ground, pos[:, NAMES.index("Head")], root[:, :2],
                      root_rot, s["body_v"][:, 0], others[:, 0, :2], v_root,
                      g, env)
    return torch.cat([base, vm, crowd_obs(others, v_root, root, root_rot, g)],
                     -1)


def control_step(b, ground, s, actions, verts, progress, env, e,
                 given=None, control=False, people=None):
    """`humanoid.control_step` with the crowd's observation: (the state
    after each substep, the observation, the reward); `people` the state
    the others are observed in (default: the last substep's). The
    control reads the observation and the reward from the states in
    bfloat16."""
    target = humanoid.pd_targets(b, actions)
    subs = humanoid.physics(b, ground, s, humanoid.exp(target), e, control,
                            given)
    last = subs[-1] if given is None else given[-1]
    people = last if people is None else people
    if control:
        last, people = humanoid.rounded(last), humanoid.rounded(people)
    p1 = progress + 1
    return (subs, observe(b, ground, last, verts, p1, env, people),
            humanoid.reward(b, last, verts, p1, target, env))


# --- the mirror --------------------------------------------------------------

def self_obs(pos, grot, vel, ang, betas):
    """The heading-local self observation from the pivot frame."""
    N = pos.shape[0]
    root, root_rot = pos[:, 0], grot[:, 0]
    hq = humanoid.heading_inv(root_rot)
    local = humanoid.rot(hq[:, None], pos - root[:, None])[:, 1:]
    rots = humanoid.tan_norm(humanoid.qmul(hq[:, None].expand(grot.shape),
                                           grot))
    return torch.cat([local.reshape(N, -1), rots.reshape(N, -1),
                      humanoid.rot(hq[:, None], vel).reshape(N, -1),
                      humanoid.rot(hq[:, None], ang).reshape(N, -1),
                      betas[:, :11]], -1)


def mirror(b, s, obs, env: dict):
    """The left/right mirror (across the body's xz plane) of the
    observation `obs` of the state `s`, as the motion-symmetry loss reads
    it: the self observation of the mirrored body (positions and
    velocities y negated, rotations and angular velocities as
    pseudovectors, left and right bodies swapped); the trajectory samples
    y negated; the sensor image's y axis reversed and its lateral channel
    negated; every (x, y, z) of the people y negated."""
    pos, grot, vel, ang = humanoid.pivot_frame(b, s)
    dev, m = pos.device, list(MIRROR_BODY)
    vec = torch.tensor([1.0, -1.0, 1.0], device=dev)
    pseudo = torch.tensor([-1.0, 1.0, -1.0], device=dev)
    qm = torch.tensor([-1.0, 1.0, -1.0, 1.0], device=dev)
    so = self_obs((pos * vec)[:, m], (grot * qm)[:, m], (vel * vec)[:, m],
                  (ang * pseudo)[:, m], b["betas"])
    N, S = obs.shape[0], so.shape[1]
    T = 2 * env["num_traj_samples"]
    R = env["sensor_res"]
    task = obs[:, S:]
    loc = task[:, :T].reshape(N, -1, 2) * vec[:2]
    img = task[:, T:T + 3 * R * R].reshape(N, R, R, 3).flip(2) \
        * torch.tensor([1.0, 1.0, -1.0], device=dev)
    people = task[:, T + 3 * R * R:].reshape(N, -1, 3) * vec
    return torch.cat([so, loc.reshape(N, -1), img.reshape(N, -1),
                      people.reshape(N, -1)], -1)


# --- the network -------------------------------------------------------------

def same_pad(width: int, stride: int = 2, kernel: int = 3) -> tuple:
    """XLA's "SAME" padding of one axis: (low, high), the odd pixel high."""
    out = -(-width // stride)
    total = max((out - 1) * stride + kernel - width, 0)
    return total // 2, total - total // 2


def param_spec(d: dict) -> list:
    """`policy.param_spec`'s leaves with the task MLP over the trajectory
    samples alone, the conv encoder (each kernel (out, in·3·3), so that
    its fan-in is its last axis: reshaped by `make`) and the pointnet.
    d: the widths of `policy.param_spec` and sensor_res, sensor_channels,
    cnn_features, pointnet_units, people_obs, top_k."""
    spec = []

    def mlp(name, i, units):
        for k, u in enumerate(units):
            spec.extend([(f"{name}.{k}.weight", (u, i), "normal", 1.0),
                         (f"{name}.{k}.bias", (u,), "const", 0.0)])
            i = u
        return i

    R, C = d["sensor_res"], d["sensor_channels"]
    emb = mlp("task_mlp", d["task_obs"] - d["people_obs"] - R * R * C,
              d["task_units"])
    w, c = R, C
    for k, f in enumerate(d["cnn_features"]):
        spec += [(f"cnn.{k}.weight", (f, c * 9), "normal", 1.0),
                 (f"cnn.{k}.bias", (f,), "const", 0.0)]
        w, c = -(-w // 2), f
    spec += [("cnn_proj.weight", (emb, w * w * c), "normal", 1.0),
             ("cnn_proj.bias", (emb,), "const", 0.0)]
    pn = mlp("point_net", d["people_obs"] // d["top_k"], d["pointnet_units"])
    h = mlp("actor_mlp", d["self_obs"] + 2 * emb + pn, d["mlp_units"])
    spec += [("mu.weight", (d["actions"], h), "normal", 0.01),
             ("mu.bias", (d["actions"],), "const", 0.0),
             ("log_sigma", (d["actions"],), "const", d["sigma_init"])]
    h = mlp("critic_mlp", d["self_obs"] + 2 * emb + pn, d["mlp_units"])
    spec += [("value.weight", (1, h), "normal", 1.0),
             ("value.bias", (1,), "const", 0.0)]
    h = mlp("disc_mlp", d["amp_obs"], d["disc_units"])
    spec += [("disc_logits.weight", (1, h), "uniform", 1.0),
             ("disc_logits.bias", (1,), "const", 0.0)]
    h = mlp("task_value_mlp", d["traj_obs"], d["value_units"])
    spec += [("value_logits.weight", (1, h), "uniform", 1.0),
             ("value_logits.bias", (1,), "const", 0.0)]
    return spec


def as_conv(params: dict) -> dict:
    """The spec's (out, in·9) conv kernels as (out, in, 3, 3)."""
    return {k: (v.reshape(v.shape[0], -1, 3, 3)
                if k.startswith("cnn.") and k.endswith(".weight") else v)
            for k, v in params.items()}


def conv_encoder(p, d, image):
    """(…, R·R·C) sensor images, channel innermost → (…, emb)."""
    R, C = d["sensor_res"], d["sensor_channels"]
    x = image.reshape(-1, R, R, C).permute(0, 3, 1, 2)
    for k in range(len(d["cnn_features"])):
        lo, hi = same_pad(x.shape[-1])
        x = torch.relu(F.conv2d(F.pad(x, (lo, hi, lo, hi)),
                                p[f"cnn.{k}.weight"], p[f"cnn.{k}.bias"],
                                stride=2))
    x = x.permute(0, 2, 3, 1).reshape(image.shape[:-1] + (-1,))
    return torch.relu(F.linear(x, p["cnn_proj.weight"], p["cnn_proj.bias"]))


def pointnet(p, d, people):
    """(…, k·33) people → (…, pointnet width): each person [its k-th
    position block | its root velocity], max-pooled over the people."""
    k = d["top_k"]
    lead = people.shape[:-1]
    pos = people[..., :-3 * k].reshape(lead + (k, -1))
    vel = people[..., -3 * k:].reshape(lead + (k, 3))
    x = torch.cat([pos, vel], -1)
    n = len(d["pointnet_units"])
    for i in range(n):
        x = F.linear(x, p[f"point_net.{i}.weight"], p[f"point_net.{i}.bias"])
        if i < n - 1:
            x = torch.relu(x)
    return x.amax(-2)


def embed(p, d, task):
    """[task MLP | conv projection | pointnet] of the task observation
    [trajectory samples | sensor image | people]."""
    t = d["traj_obs"]
    img = d["sensor_res"] ** 2 * d["sensor_channels"]
    P = d["people_obs"]
    rest = torch.cat([task[..., :t], task[..., t + img:-P]], -1)
    return torch.cat([policy._mlp(p, "task_mlp", rest, len(d["task_units"])),
                      conv_encoder(p, d, task[..., t:t + img]),
                      pointnet(p, d, task[..., -P:])], -1)


def heads(p: dict, d: dict, obs, actor=True, critic=True, task_value=False):
    """`policy.heads` over the crowd's embedding."""
    S, T = d["self_obs"], d["task_obs"]
    task = obs[..., S:S + T]
    x = torch.cat([obs[..., :S], embed(p, d, task)], -1)
    out = {}
    if actor:
        mu = F.linear(policy._mlp(p, "actor_mlp", x, len(d["mlp_units"])),
                      p["mu.weight"], p["mu.bias"])
        out["mu"], out["sigma"] = mu, torch.exp(p["log_sigma"]).expand_as(mu)
    if critic:
        out["v"] = F.linear(policy._mlp(p, "critic_mlp", x,
                                        len(d["mlp_units"])),
                            p["value.weight"], p["value.bias"])[..., 0]
    if task_value:
        out["tv"] = F.linear(policy._mlp(p, "task_value_mlp",
                                         task[..., :d["traj_obs"]],
                                         len(d["value_units"])),
                             p["value_logits.weight"],
                             p["value_logits.bias"])[..., 0]
    return out


def minibatch_loss(p, d, ac: dict, mb: dict, demo, replay, masks):
    """`policy.minibatch_loss` through the crowd's heads."""
    half = replay.shape[0]
    amp_roll = mb["amp_n"][:half]
    if masks is not None:
        amp_roll, replay, demo = (amp_roll * masks[0], replay * masks[1],
                                  demo * masks[2])
    h = heads(p, d, mb["obs_n"], task_value=True)
    mu = h["mu"]
    ratio = torch.exp(torch.clamp(policy.logp(mu, h["sigma"], mb["action"])
                                  - mb["logp"], -16.0, 16.0))
    clipped = torch.clamp(ratio, 1 - ac["e_clip"], 1 + ac["e_clip"])
    a_loss = -torch.minimum(ratio * mb["adv"], clipped * mb["adv"]).mean()
    c_loss = 0.5 * ((h["v"] - mb["ret_n"]) ** 2).mean()
    b_loss = (torch.relu(mu - 1.1) ** 2 + torch.relu(-1.1 - mu) ** 2).sum(
        -1).mean()
    agent = policy.disc(p, torch.cat([amp_roll, replay]))
    demo = demo.detach().requires_grad_()
    demo_logit = policy.disc(p, demo)
    d_loss = 0.5 * (F.softplus(agent).mean() + F.softplus(-demo_logit).mean())
    logit_reg = (p["disc_logits.weight"] ** 2).sum()
    g, = torch.autograd.grad(demo_logit.sum(), demo, create_graph=True)
    grad_pen = (g ** 2).sum(-1).mean()
    w_decay = sum((p[f"disc_mlp.{k}.weight"] ** 2).sum()
                  for k in range(len(d["disc_units"]))) + logit_reg
    disc_total = (d_loss + ac["disc_logit_reg"] * logit_reg
                  + ac["disc_grad_penalty"] * grad_pen
                  + ac["disc_weight_decay"] * w_decay)
    tv_loss = ((h["tv"] - mb["ret_01"]) ** 2).mean()
    total = (ac["actor_coef"] * a_loss + ac["critic_coef"] * c_loss
             + ac["bounds_coef"] * b_loss + ac["disc_coef"] * disc_total
             + ac["tv_coef"] * tv_loss)
    if ac["motion_sym_loss"]:
        mu_f = heads(p, d, mb["flip_obs_n"], critic=False)["mu"]
        total = total + ac["sym_coef"] * ((mu - policy.flip_actions(mu_f))
                                          ** 2).sum(-1).mean()
    return total


def train(params, d, ac, minibatches):
    """`policy.train` through the crowd's loss: (losses, first moment after
    step 1, the clipped first gradient, params after the last)."""
    state = optim.zeros_state(params)
    losses, m1, g1 = [], None, None
    for mb, demo, replay, masks in minibatches:
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        total = minibatch_loss(p, d, ac, mb, demo, replay, masks)
        grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
        grads = optim.clip_global(grads, ac["grad_norm"])
        params, state = optim.step({k: v.detach() for k, v in
                                    params.items()}, grads, state, ac["lr"])
        losses.append(float(total.detach()))
        if m1 is None:
            m1, g1 = dict(state["m"]), grads
    return losses, m1, g1, params
