"""Policy, critic, discriminator and task-value networks, and the LocoVal
function (port of emloco_tpu/learning/networks.py AMPSeptValueNet and
ValuePoseNet).

A task MLP [512, 256] embeds the task observation [trajectory, sensor];
its embedding, concatenated with the self observation, feeds the actor MLP
[2048, 1024] → μ, with a fixed state-independent σ = exp(log_sigma), and
the critic MLP [2048, 1024] → V. The discriminator [1024, 512] → logit reads
the flattened AMP window; the task-value head [15, 6] → 1 reads the
trajectory part of the task observation (no sigmoid). With a crowd
observation at the end of the task observation (`people_obs_dim`), a
pointnet [32, 64, 64] embeds each of the 5 people and is max-pooled over
them, beside the task MLP's embedding. AMPSeptCNNNet (port of
AMPSeptCNNNet) encodes the sensor image with three stride-2 3×3 convs
[16, 32, 32] and a projection to 256 instead of flattening it into the task
MLP. The conv encoder and the pointnet are the program's spans `policy.cnn`
and `policy.pointnet` (utils/profiling.annotate); `CONV_ENCODER` counts the
encoder's calls and rows on the host.

With `hidden_bf16` the layers that the JAX package builds with
`dtype=bfloat16` (the task MLP, the pointnet, the actor, critic and disc
MLPs) compute in bfloat16 as flax's Dense does: input, kernel and bias cast
to bfloat16, the product rounded to bfloat16, then the bias added in
bfloat16. The parameters stay float32, and so do μ, V, the logits, the
task-value MLP, the convs and the projection.

Initialization follows flax's defaults (truncated-normal fan-in scaling,
zero biases; the μ layer at scale 0.01; the disc and value logits uniform in
±1/√fan_in), drawn from a torch.Generator.

ValuePoseNet maps an episode's waypoints, initial pose and initial root
velocity, rotated so that the first segment points along +x, through an MLP
in → in/2 − 1 → (in/2 − 1)/2 → 1 to a sigmoid plausibility value; its
kernels are xavier-uniform and its biases zero, as flax's Dense with
`kernel_init=xavier_uniform()`.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import device as _device
from ..utils.profiling import annotate

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978

# calls and rows (images) of AMPSeptCNNNet's conv encoder since the last
# reset, counted on the host from shapes (no device sync)
CONV_ENCODER = {"calls": 0, "rows": 0}


def reset_conv_counts():
    CONV_ENCODER["calls"] = 0
    CONV_ENCODER["rows"] = 0


def _mlp(in_dim: int, units: Sequence[int]) -> nn.ModuleList:
    layers = []
    for u in units:
        layers.append(nn.Linear(in_dim, u))
        in_dim = u
    return nn.ModuleList(layers)


def _dense(layer: nn.Linear, x, dtype=None):
    """layer(x); in `dtype` (bfloat16) as flax's Dense(dtype=...) computes:
    every operand cast, the product rounded, then the bias added."""
    if dtype is None:
        return layer(x)
    return (F.linear(x.to(dtype), layer.weight.to(dtype))
            + layer.bias.to(dtype))


def _run_mlp(layers, x, dtype=None):
    """The layers with ReLU, in `dtype` where given; the output in x's
    dtype."""
    out = x.dtype
    for layer in layers:
        x = torch.relu(_dense(layer, x, dtype))
    return x.to(out)


def _same_pad(width: int, stride: int = 2, kernel: int = 3):
    """XLA's "SAME" padding of one spatial axis: (low, high), the odd one
    on the high side."""
    out = -(-width // stride)
    total = max((out - 1) * stride + kernel - width, 0)
    return total // 2, total - total // 2


class AMPSeptValueNet(nn.Module):
    """obs = [self obs | task obs] → (μ, σ), V, task value; the AMP window →
    disc logit."""

    def __init__(self, num_actions: int, self_obs_dim: int,
                 traj_obs_dim: int, task_obs_dim: int,
                 amp_obs_dim: int,
                 mlp_units: Sequence[int] = (2048, 1024),
                 task_units: Sequence[int] = (512, 256),
                 value_units: Sequence[int] = (15, 6),
                 disc_units: Sequence[int] = (1024, 512),
                 sigma_init: float = -2.9,
                 people_obs_dim: int = 0, pointnet_topk: int = 5,
                 pointnet_emb: int = 64, hidden_bf16: bool = False,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = _device.resolve(device)
        self.self_obs_dim = self_obs_dim
        self.traj_obs_dim = traj_obs_dim
        self.task_obs_dim = task_obs_dim
        self.people_obs_dim = people_obs_dim
        self.pointnet_topk = pointnet_topk
        self.hidden_dtype = torch.bfloat16 if hidden_bf16 else None
        self.task_mlp = _mlp(self._task_mlp_in(task_obs_dim), task_units)
        emb = self._build_task_encoders(task_units[-1])
        if people_obs_dim:
            per = people_obs_dim // pointnet_topk
            self.point_net = _mlp(per, (32, 64, pointnet_emb))
            emb += pointnet_emb
        self.actor_mlp = _mlp(self_obs_dim + emb, mlp_units)
        self.mu = nn.Linear(mlp_units[-1], num_actions)
        self.log_sigma = nn.Parameter(
            torch.full((num_actions,), sigma_init))
        self.critic_mlp = _mlp(self_obs_dim + emb, mlp_units)
        self.value = nn.Linear(mlp_units[-1], 1)
        self.disc_mlp = _mlp(amp_obs_dim, disc_units)
        self.disc_logits = nn.Linear(disc_units[-1], 1)
        self.task_value_mlp = _mlp(traj_obs_dim, value_units)
        self.value_logits = nn.Linear(value_units[-1], 1)
        self.to(dev)
        self.init_parameters(generator)

    def _task_mlp_in(self, task_obs_dim):
        """The task MLP's input width: the task obs without the people."""
        return task_obs_dim - self.people_obs_dim

    def _build_task_encoders(self, task_emb):
        """Build the layers that embed the task obs beside the task MLP
        (none here); returns the embedding's width before the people's."""
        return task_emb

    def _lecun_layers(self):
        """The layers drawn lecun-normal, in drawing order."""
        return (*self.task_mlp, *getattr(self, "point_net", ()),
                *self.actor_mlp, self.mu, *self.critic_mlp, self.value,
                *self.disc_mlp, *self.task_value_mlp)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator | None = None):
        """flax defaults: lecun (fan-in) truncated normal, μ at scale 0.01,
        zero biases; the disc and value logits' kernels symmetric uniform at
        1/√fan_in. The actor's layers draw first."""
        for layer in self._lecun_layers():
            scale = 0.01 if layer is self.mu else 1.0
            w = layer.weight
            fan_in = w[0].numel()
            std = math.sqrt(scale / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            nn.init.zeros_(layer.bias)
        for layer in (self.disc_logits, self.value_logits):
            bound = 1.0 / math.sqrt(layer.in_features)
            nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
            nn.init.zeros_(layer.bias)

    def _split(self, obs):
        self_obs = obs[..., :self.self_obs_dim]
        task_obs = obs[..., self.self_obs_dim:
                       self.self_obs_dim + self.task_obs_dim]
        return self_obs, task_obs

    def _split_people(self, task_obs):
        """(task obs without the people, the people or None)."""
        if not self.people_obs_dim:
            return task_obs, None
        return (task_obs[..., :-self.people_obs_dim],
                task_obs[..., -self.people_obs_dim:])

    def task_embed(self, task_obs):
        """[task MLP embedding | people embedding]."""
        head, people = self._split_people(task_obs)
        feats = [_run_mlp(self.task_mlp, head, self.hidden_dtype)]
        if people is not None:
            feats.append(self._people_feat(people))
        return torch.cat(feats, -1)

    def _people_feat(self, people):
        """The pointnet over the people, max-pooled. The crowd observation
        holds all k position blocks, then the k root velocities; each point
        is one person's [10 joints | root velocity]."""
        with annotate("policy.pointnet"):
            k = self.pointnet_topk
            nv = 3 * k
            pos = people[..., :self.people_obs_dim - nv]
            vel = people[..., self.people_obs_dim - nv:]
            p = torch.cat([pos.reshape(pos.shape[:-1] + (k, -1)),
                           vel.reshape(vel.shape[:-1] + (k, 3))], -1)
            last = len(self.point_net) - 1
            for i, layer in enumerate(self.point_net):
                p = _dense(layer, p, self.hidden_dtype)
                if i < last:
                    p = torch.relu(p)
            return p.max(-2).values.to(people.dtype)

    def actor(self, obs):
        self_obs, task_obs = self._split(obs)
        h = _run_mlp(self.actor_mlp,
                     torch.cat([self_obs, self.task_embed(task_obs)], -1),
                     self.hidden_dtype)
        mu = self.mu(h)
        return mu, torch.exp(self.log_sigma) * torch.ones_like(mu)

    def critic(self, obs):
        self_obs, task_obs = self._split(obs)
        h = _run_mlp(self.critic_mlp,
                     torch.cat([self_obs, self.task_embed(task_obs)], -1),
                     self.hidden_dtype)
        return self.value(h)[..., 0]

    def disc(self, amp_obs):
        h = _run_mlp(self.disc_mlp, amp_obs, self.hidden_dtype)
        return self.disc_logits(h)[..., 0]

    def task_value(self, obs):
        """The LocoVal head over the trajectory part of the task obs."""
        traj_obs = self._split(obs)[1][..., :self.traj_obs_dim]
        return self.value_logits(
            _run_mlp(self.task_value_mlp, traj_obs))[..., 0]

    def forward(self, *inputs, method: str | None = None):
        """All heads on (obs, amp_obs) → (μ, σ, V, disc logit, task value),
        or the one head `method` names on its own input: the entry through
        which torch.func.functional_call runs a head under given
        parameters, as flax's `apply(..., method=)`."""
        if method is not None:
            return getattr(self, method)(*inputs)
        obs, amp_obs = inputs
        mu, sigma = self.actor(obs)
        return (mu, sigma, self.critic(obs), self.disc(amp_obs),
                self.task_value(obs))


class AMPSeptCNNNet(AMPSeptValueNet):
    """The sensor image (res × res × C, channel innermost, after the
    trajectory samples) goes through three stride-2 3×3 convs with ReLU and
    XLA's "SAME" padding, flattened in (H, W, C) order, and a ReLU
    projection to the task embedding's width; the task MLP reads the
    trajectory samples and whatever follows the image but the people.
    Embedding: [task MLP | conv projection | people]."""

    def __init__(self, *args, sensor_res: int = 32,
                 sensor_channels: int = 1,
                 cnn_features: Sequence[int] = (16, 32, 32), **kw):
        self.sensor_res = sensor_res
        self.sensor_channels = sensor_channels
        self.cnn_features = tuple(cnn_features)
        super().__init__(*args, **kw)

    def _task_mlp_in(self, task_obs_dim):
        return (task_obs_dim - self.people_obs_dim
                - self.sensor_res ** 2 * self.sensor_channels)

    def _build_task_encoders(self, task_emb):
        width, chans = self.sensor_res, self.sensor_channels
        convs = []
        for f in self.cnn_features:
            convs.append(nn.Conv2d(chans, f, 3, stride=2))
            width, chans = -(-width // 2), f
        self.cnn = nn.ModuleList(convs)
        self.cnn_proj = nn.Linear(width * width * chans, task_emb)
        return 2 * task_emb

    def _lecun_layers(self):
        return (*super()._lecun_layers(), *self.cnn, self.cnn_proj)

    def task_embed(self, task_obs):
        head, people = self._split_people(task_obs)
        t = self.traj_obs_dim
        img_dim = self.sensor_res ** 2 * self.sensor_channels
        lead = head.shape[:-1]
        with annotate("policy.cnn"):
            h = head[..., t:t + img_dim].reshape(
                (-1, self.sensor_res, self.sensor_res, self.sensor_channels))
            CONV_ENCODER["calls"] += 1
            CONV_ENCODER["rows"] += h.shape[0]
            h = h.permute(0, 3, 1, 2)                       # NHWC → NCHW
            for conv in self.cnn:
                lo_h, hi_h = _same_pad(h.shape[2])
                lo_w, hi_w = _same_pad(h.shape[3])
                h = torch.relu(conv(F.pad(h, (lo_w, hi_w, lo_h, hi_h))))
            h = h.permute(0, 2, 3, 1).reshape(lead + (-1,))  # (H, W, C)
            h = torch.relu(self.cnn_proj(h))
        feats = [
            _run_mlp(self.task_mlp, torch.cat(
                [head[..., :t], head[..., t + img_dim:]], -1),
                self.hidden_dtype),
            h]
        if people is not None:
            feats.append(self._people_feat(people))
        return torch.cat(feats, -1)


class ValuePoseNet(nn.Module):
    """The LocoVal function (reference value_pose_net.py:10-159)."""

    def __init__(self, use_pose: bool = True, use_vel: bool = True,
                 hide_toe: bool = True, hide_spine: bool = True,
                 normalize: bool = True, num_waypoints: int = 13,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.use_pose = use_pose
        self.use_vel = use_vel
        self.hide_toe = hide_toe
        self.hide_spine = hide_spine
        self.normalize = normalize
        self.num_waypoints = num_waypoints
        in_dim = self.traj_size + 72 * use_pose + 2 * use_vel
        fc1 = in_dim // 2 - 1
        fc2 = fc1 // 2
        self.fc1 = nn.Linear(in_dim, fc1)
        self.fc2 = nn.Linear(fc1, fc2)
        self.fc3 = nn.Linear(fc2, 1)
        self.to(_device.resolve(device))
        self.init_parameters(generator)

    @property
    def traj_size(self) -> int:
        """The flattened waypoints' width, the first of fc1's inputs."""
        return self.num_waypoints * 2

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator | None = None):
        """flax's xavier_uniform kernels, U(±√(6 / (fan_in + fan_out))), and
        zero biases; fc1, fc2, fc3 draw in turn."""
        for layer in (self.fc1, self.fc2, self.fc3):
            bound = math.sqrt(6.0 / (layer.in_features + layer.out_features))
            nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, waypoint_traj, init_pose=None, init_vel=None):
        """waypoint_traj (B, W, 2); init_pose (B, 24, 3); init_vel (B, 2).
        Returns (B,) plausibility values in [0, 1]."""
        if self.normalize:
            waypoint_traj, init_pose, init_vel = rotate_normalization(
                waypoint_traj, init_pose, init_vel)
        parts = [waypoint_traj.reshape(waypoint_traj.shape[0], -1)]
        if self.use_pose:
            if init_pose is None:
                raise ValueError("this ValuePoseNet needs init_pose")
            # hide the toe joints 4 / 8 and the spine chain 9 / 10 / 11
            # (reference forward_pose / forward_full, :120-150)
            hidden = [4, 8] * self.hide_toe + [9, 10, 11] * self.hide_spine
            if hidden:
                init_pose = init_pose.clone()
                init_pose[:, hidden] = 0.0
            parts.append(init_pose.reshape(init_pose.shape[0], -1))
        if self.use_vel:
            if init_vel is None:
                raise ValueError("this ValuePoseNet needs init_vel")
            parts.append(init_vel)
        x = torch.cat(parts, -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return torch.sigmoid(self.fc3(x))[..., 0]


def rotate_normalization(waypoint_traj, init_pose=None, init_vel=None):
    """Rotate so that the first trajectory segment points along +x
    (reference _rotate_normalization, value_pose_net.py:73-103: row vectors
    times R(angle) on the right, a rotation by −angle)."""
    eps = 1e-10
    x1 = waypoint_traj[:, 1, 0]
    y1 = waypoint_traj[:, 1, 1]
    x1 = torch.where(x1.abs() < eps, eps, x1)
    ang = torch.atan2(y1, x1)
    c, s = torch.cos(ang), torch.sin(ang)
    # row vector × [[c, −s], [s, c]]
    rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                      -2)
    traj = torch.einsum("bwj,bji->bwi", waypoint_traj[..., :2], rot)
    if init_pose is not None:
        xy = torch.einsum("bkj,bji->bki", init_pose[..., :2], rot)
        init_pose = torch.cat([xy, init_pose[..., 2:]], -1)
    if init_vel is not None:
        init_vel = torch.einsum("bj,bji->bi", init_vel[..., :2], rot)
    return traj, init_pose, init_vel


def embodied_motion_loss(value_fn, pred_traj, init_pose=None, init_vel=None):
    """The EmLoco loss: mean (v − 1)² of the plausibility values `value_fn`
    gives the predicted trajectories, pushing them toward 1 (reference
    calc_embodied_motion_loss, value_pose_net.py:151-159). `value_fn` is a
    ValuePoseNet or any callable (traj, init_pose, init_vel) → (B,)."""
    v = value_fn(pred_traj, init_pose, init_vel)
    return torch.mean((v - 1.0) ** 2)
