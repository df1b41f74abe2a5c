"""PACER's PPO + AMP network and update, plain PyTorch.

The network (PACER, amp_humanoid_smpl_sept_task.yaml; the "sept" net):
the task observation [trajectory samples | height map] goes through a task
MLP (512, 256); its embedding beside the self observation feeds an actor
MLP (2048, 1024) to μ, with a state-independent σ = exp(log σ), and a
critic MLP (2048, 1024) to V; the discriminator MLP (1024, 512) maps the
AMP window to a logit; the task-value MLP (15, 6) maps the trajectory
samples to a value. ReLU throughout.

One minibatch's loss (rl_games' a2c_continuous with AMP, Peng et al. 2021):
  PPO's clipped surrogate over the ratio exp(clamp(logp − old, ±16)),
  ½ the squared error of V to the normalized return, the action-bounds
  penalty Σ relu(|μ| − 1.1)², the discriminator's ½(softplus of the agent
  logits + softplus of −the demo logits) with the logit-weight penalty,
  the R1 gradient penalty on the demo batch and the weight decay of its
  kernels, the task value's squared error to the return mapped to [0, 1],
  and the motion-symmetry loss between μ and the mirrored μ of the mirrored
  observation; the update clips by global norm, then Adam.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import optim

# the SMPL humanoid's bodies (PACER's smpl_humanoid.xml order); the mirror
# swaps every L_ body with its R_ twin
BODY_NAMES = (
    "Pelvis", "L_Hip", "L_Knee", "L_Ankle", "L_Toe",
    "R_Hip", "R_Knee", "R_Ankle", "R_Toe",
    "Torso", "Spine", "Chest", "Neck", "Head",
    "L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand",
    "R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand")


def _mirror_joints() -> list:
    out = []
    for n in BODY_NAMES[1:]:
        twin = ("R_" + n[2:] if n.startswith("L_") else
                "L_" + n[2:] if n.startswith("R_") else n)
        out.append(BODY_NAMES.index(twin) - 1)
    return out


MIRROR_JOINTS = _mirror_joints()


def flip_actions(a: torch.Tensor) -> torch.Tensor:
    """Exp-map actions mirrored: joints swapped left-right, x and z
    negated."""
    j = a.reshape(a.shape[0], -1, 3)[:, MIRROR_JOINTS]
    return (j * torch.tensor([-1.0, 1.0, -1.0], device=a.device)).reshape(
        a.shape)


def param_spec(d: dict) -> list:
    """d: self_obs, task_obs, traj_obs, amp_obs, actions and the widths."""
    spec = []

    def mlp(name, i, units, kind="normal", scale=1.0):
        for k, u in enumerate(units):
            spec.extend([(f"{name}.{k}.weight", (u, i), kind, scale),
                         (f"{name}.{k}.bias", (u,), "const", 0.0)])
            i = u
        return i

    emb = mlp("task_mlp", d["task_obs"], d["task_units"])
    h = mlp("actor_mlp", d["self_obs"] + emb, d["mlp_units"])
    spec += [("mu.weight", (d["actions"], h), "normal", 0.01),
             ("mu.bias", (d["actions"],), "const", 0.0),
             ("log_sigma", (d["actions"],), "const", d["sigma_init"])]
    h = mlp("critic_mlp", d["self_obs"] + emb, d["mlp_units"])
    spec += [("value.weight", (1, h), "normal", 1.0),
             ("value.bias", (1,), "const", 0.0)]
    h = mlp("disc_mlp", d["amp_obs"], d["disc_units"])
    spec += [("disc_logits.weight", (1, h), "uniform", 1.0),
             ("disc_logits.bias", (1,), "const", 0.0)]
    h = mlp("task_value_mlp", d["traj_obs"], d["value_units"])
    spec += [("value_logits.weight", (1, h), "uniform", 1.0),
             ("value_logits.bias", (1,), "const", 0.0)]
    return spec


def _mlp(p, name, x, n):
    for k in range(n):
        x = torch.relu(F.linear(x, p[f"{name}.{k}.weight"],
                                p[f"{name}.{k}.bias"]))
    return x


def heads(p: dict, d: dict, obs, actor=True, critic=True, task_value=False):
    """The heads on the normalized obs, the task MLP run once: a dict of
    mu, sigma, v, tv as asked."""
    S, T = d["self_obs"], d["task_obs"]
    self_obs, task = obs[..., :S], obs[..., S:S + T]
    x = torch.cat([self_obs, _mlp(p, "task_mlp", task, 2)], -1)
    out = {}
    if actor:
        mu = F.linear(_mlp(p, "actor_mlp", x, 2), p["mu.weight"],
                      p["mu.bias"])
        out["mu"], out["sigma"] = mu, torch.exp(p["log_sigma"]).expand_as(mu)
    if critic:
        out["v"] = F.linear(_mlp(p, "critic_mlp", x, 2), p["value.weight"],
                            p["value.bias"])[..., 0]
    if task_value:
        out["tv"] = F.linear(_mlp(p, "task_value_mlp",
                                  task[..., :d["traj_obs"]], 2),
                             p["value_logits.weight"],
                             p["value_logits.bias"])[..., 0]
    return out


def disc(p, x):
    return F.linear(_mlp(p, "disc_mlp", x, 2), p["disc_logits.weight"],
                    p["disc_logits.bias"])[..., 0]


def logp(mu, sigma, a):
    return (-0.5 * ((a - mu) / sigma) ** 2 - torch.log(sigma)
            - 0.5 * math.log(2 * math.pi)).sum(-1)


def normalize(x, mean, var, clip=5.0):
    return torch.clamp((x - mean) / torch.sqrt(var + 1e-5), -clip, clip)


def minibatch_loss(p, d, ac: dict, mb: dict, demo, replay, masks):
    """The total loss of one minibatch (rows `mb`, demo and replay blocks,
    the three AMP dropout masks or None)."""
    half = replay.shape[0]
    amp_roll = mb["amp_n"][:half]
    if masks is not None:
        amp_roll, replay, demo = (amp_roll * masks[0], replay * masks[1],
                                  demo * masks[2])
    h = heads(p, d, mb["obs_n"], task_value=True)
    mu = h["mu"]
    ratio = torch.exp(torch.clamp(logp(mu, h["sigma"], mb["action"])
                                  - mb["logp"], -16.0, 16.0))
    clipped = torch.clamp(ratio, 1 - ac["e_clip"], 1 + ac["e_clip"])
    a_loss = -torch.minimum(ratio * mb["adv"], clipped * mb["adv"]).mean()
    c_loss = 0.5 * ((h["v"] - mb["ret_n"]) ** 2).mean()
    b_loss = (torch.relu(mu - 1.1) ** 2 + torch.relu(-1.1 - mu) ** 2).sum(
        -1).mean()
    agent = disc(p, torch.cat([amp_roll, replay]))
    demo = demo.detach().requires_grad_()
    demo_logit = disc(p, demo)
    d_loss = 0.5 * (F.softplus(agent).mean() + F.softplus(-demo_logit).mean())
    logit_reg = (p["disc_logits.weight"] ** 2).sum()
    g, = torch.autograd.grad(demo_logit.sum(), demo, create_graph=True)
    grad_pen = (g ** 2).sum(-1).mean()
    w_decay = sum((p[f"disc_mlp.{k}.weight"] ** 2).sum()
                  for k in range(2)) + logit_reg
    disc_total = (d_loss + ac["disc_logit_reg"] * logit_reg
                  + ac["disc_grad_penalty"] * grad_pen
                  + ac["disc_weight_decay"] * w_decay)
    tv_loss = ((h["tv"] - mb["ret_01"]) ** 2).mean()
    total = (ac["actor_coef"] * a_loss + ac["critic_coef"] * c_loss
             + ac["bounds_coef"] * b_loss + ac["disc_coef"] * disc_total
             + ac["tv_coef"] * tv_loss)
    if ac["motion_sym_loss"]:
        mu_f = heads(p, d, mb["flip_obs_n"], critic=False)["mu"]
        total = total + ac["sym_coef"] * ((mu - flip_actions(mu_f)) ** 2).sum(
            -1).mean()
    return total


def train(params, d, ac, minibatches):
    """The program's first minibatch steps: (losses, first moment after
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
