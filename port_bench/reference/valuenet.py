"""The LocoVal function and its training, plain PyTorch.

The net (EmLoco, value_pose_net.py:10-159): waypoints (B, W, 2), the
initial pose (B, 24, 3) and root velocity (B, 2), rotated so that the first
segment points along +x, the toe joints 4, 8 and the spine chain 9-11 of
the pose zeroed, flattened into in = 2W + 72 + 2 features, then
in → in/2 − 1 → (in/2 − 1)/2 → 1, ReLU between, a sigmoid last.

Its training (amp_continuous_value.py:23-454): each env's discounted
combined reward, a heading-inverted env's reward times −penalty, latched
once an episode at its end or at step_to_pred, normalized to [0, 1]; the
loss is the MSE over the latched samples; one AdamW step an epoch on a
warm-up cosine schedule (peak lr, from 0.1·lr over the warm-up to 0.01·lr).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import optim

HIDDEN_JOINTS = (4, 8, 9, 10, 11)


def param_spec(num_waypoints: int = 13) -> list:
    i = 2 * num_waypoints + 72 + 2
    h1 = i // 2 - 1
    h2 = h1 // 2
    spec = []
    for name, a, b in (("fc1", i, h1), ("fc2", h1, h2), ("fc3", h2, 1)):
        spec += [(name + ".weight", (b, a), "uniform", None),
                 (name + ".bias", (b,), "const", 0.0)]
    return spec


def forward(p: dict, traj, pose, vel):
    x1 = traj[:, 1, 0]
    x1 = torch.where(x1.abs() < 1e-10, torch.full_like(x1, 1e-10), x1)
    ang = torch.atan2(traj[:, 1, 1], x1)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

    def rot(xy):                         # a rotation by −ang
        return torch.stack([xy[..., 0] * c + xy[..., 1] * s,
                            -xy[..., 0] * s + xy[..., 1] * c], -1)

    t = rot(traj)
    pxy = rot(pose[..., :2])
    pose = torch.cat([pxy, pose[..., 2:]], -1).clone()
    pose[:, list(HIDDEN_JOINTS)] = 0.0
    v = torch.stack([vel[:, 0] * c[:, 0] + vel[:, 1] * s[:, 0],
                     -vel[:, 0] * s[:, 0] + vel[:, 1] * c[:, 0]], -1)
    x = torch.cat([t.reshape(t.shape[0], -1), pose.reshape(pose.shape[0], -1),
                   v], -1)
    x = torch.relu(F.linear(x, p["fc1.weight"], p["fc1.bias"]))
    x = torch.relu(F.linear(x, p["fc2.weight"], p["fc2.bias"]))
    return torch.sigmoid(F.linear(x, p["fc3.weight"], p["fc3.bias"]))[:, 0]


def latch(vc: dict, cum, factor, already, reward, done, progress, inverted):
    """One control step of the return latching → (cum, factor, already,
    target, latched)."""
    r = torch.where(inverted, -vc["inversion_penalty"] * reward, reward)
    cum = cum + factor * r
    latched = (done | ((progress + 1) >= vc["step_to_pred"])) & ~already
    target = torch.clamp((cum - vc["min_cum"]) / (vc["max_cum"]
                                                  - vc["min_cum"]), 0, 1)
    already = (already | latched) & ~done
    cum = torch.where(done, torch.zeros_like(cum), cum)
    factor = torch.where(done, torch.ones_like(factor), factor * vc["gamma"])
    return cum, factor, already, target, latched


def masked_mse(p, s):
    pred = forward(p, s["wp"], s["pose"], s["vel"])
    return ((pred - s["target"]) ** 2 * s["valid"]).sum() / torch.clamp(
        s["valid"].sum(), min=1.0)


def train(params, vc: dict, epochs):
    """One AdamW step on each epoch's samples: (losses, first moment after
    step 1, the first gradient, params after the last)."""
    state = optim.zeros_state(params)
    losses, m1, g1 = [], None, None
    for s in epochs:
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        total = masked_mse(p, s)
        grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
        lr = optim.warmup_cosine(state["count"], 0.1 * vc["lr"], vc["lr"],
                                 vc["warmup_steps"], vc["total_steps"],
                                 0.01 * vc["lr"])
        params, state = optim.step({k: v.detach() for k, v in
                                    params.items()}, grads, state, lr,
                                   vc["weight_decay"])
        losses.append(float(total.detach()))
        if m1 is None:
            m1, g1 = dict(state["m"]), grads
    return losses, m1, g1, params
