"""Social-Transmotion trained with the EmLoco loss, plain PyTorch.

The model (Saadatnejad et al., "Social-Transmotion", ICLR 2024;
social-transmotion/model_jta.py): per person, 21 trajectory tokens (9
observed, the future padded with the last observed) and, per observed
frame, a 3D box, a 2D box, 24 3D joints and 22 2D joints, each projected to
`nhid` and given a learned positional embedding: 21 + 9·48 = 453 tokens.
A post-LN transformer (the local encoder) runs over each person's tokens,
with a residual; the global encoder runs over every person's 21 trajectory
tokens with the padded people's keys masked, with a residual; `nmode`
heads of 2 read person 0's tokens. Train-time masking drops trajectory
points, joints, frames and whole modalities; dropout follows the
attention weights, the attention output, the feed-forward's hidden layer
and its output.

The loss (train_jta.py:192-308): winner-takes-all, the mean over the
predicted frames of the L2 distance, min over modes, mean over the batch,
×100; plus weight × the EmLoco loss, mean (v − 1)² of the LocoVal net's
value of every mode's trajectory (origin first) with the primary's z-up
pose and velocity. The optimizer: clip by global norm, then Adam at
lr·decay^⌊t / transition⌋.

Random numbers: the eight masking uniforms, then every dropout uniform in
forward order, all drawn with torch.rand on the given generator's device,
in the order and shapes the model's published draw order fixes, so that a
generator seeded alike reproduces the masks of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import optim, valuenet

OBS, TOTAL = 9, 21
J3, J2 = 24, 22


def param_spec(c: dict) -> list:
    """(name, shape, kind, scale) of every parameter, in the model's
    state_dict names."""
    D, FF = c["nhid"], c["dim_ff"]
    spec = []

    def lin(name, i, o):
        spec.extend([(name + ".weight", (o, i), "normal", 1.0),
                     (name + ".bias", (o,), "const", 0.0)])

    def ln(name):
        spec.extend([(name + ".weight", (D,), "const", 1.0),
                     (name + ".bias", (D,), "const", 0.0)])

    lin("fc_in_traj", 2, D)
    spec += [("pe_traj_time", (TOTAL, D), "embed", 0.02),
             ("pe_traj_id", (1, D), "embed", 0.02)]
    lin("fc_in_3dbb", 4, D)
    spec.append(("pe_3dbb", (OBS, D), "embed", 0.02))
    lin("fc_in_2dbb", 4, D)
    spec.append(("pe_2dbb", (OBS, D), "embed", 0.02))
    lin("fc_in_3dpose", 3, D)
    spec.append(("pe_3dpose", (OBS * J3, D), "embed", 0.02))
    lin("fc_in_2dpose", 2, D)
    spec.append(("pe_2dpose", (OBS * J2, D), "embed", 0.02))
    for stack, n in (("local", c["nlayers_local"]),
                     ("global", c["nlayers_global"])):
        for i in range(n):
            p = f"{stack}.{i}"
            for q in ("query", "key", "value", "out"):
                lin(f"{p}.attn.{q}", D, D)
            ln(f"{p}.norm1")
            lin(f"{p}.ff1", D, FF)
            lin(f"{p}.ff2", FF, D)
            ln(f"{p}.norm2")
    lin("heads", D, 2 * c["nmode"])
    return spec


def _rand(gen, shape, device):
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


def _drop(x, rate, gen):
    keep = _rand(gen, x.shape, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _lin(p, name, x):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def _layer(p, pre, x, mask, c, gen):
    B, S, D = x.shape
    H, rate = c["nhead"], c["dropout"]
    Dh = D // H
    q = _lin(p, pre + ".attn.query", x).reshape(B, S, H, Dh) / math.sqrt(Dh)
    k = _lin(p, pre + ".attn.key", x).reshape(B, S, H, Dh)
    v = _lin(p, pre + ".attn.value", x).reshape(B, S, H, Dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None, :],
                                    torch.finfo(logits.dtype).min)
    w = _drop(torch.softmax(logits, -1), rate, gen)
    a = _lin(p, pre + ".attn.out",
             torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, D))
    x = F.layer_norm(x + _drop(a, rate, gen), (D,), p[pre + ".norm1.weight"],
                     p[pre + ".norm1.bias"], 1e-5)
    h = torch.relu(_lin(p, pre + ".ff1", x))
    h = _lin(p, pre + ".ff2", _drop(h, rate, gen))
    return F.layer_norm(x + _drop(h, rate, gen), (D,),
                        p[pre + ".norm2.weight"], p[pre + ".norm2.bias"],
                        1e-5)


def forward(p: dict, c: dict, tokens, present, gen):
    """Train-mode forward: tokens (B, 9, N, 49, 4), present (B, N) →
    (B, 21, nmode, 2) for person 0."""
    B, _, N = tokens.shape[:3]
    D = c["nhid"]
    dev = tokens.device
    tgt = torch.cat([tokens, tokens[:, -1:].expand(-1, TOTAL - OBS, -1, -1,
                                                   -1)], 1)
    traj = tgt[:, :, :, 0, :2]
    b3, b2 = tgt[:, :, :, 1, :4], tgt[:, :, :, 2, :4]
    p3, p2 = tgt[:, :, :, 3:3 + J3, :3], tgt[:, :, :, 3 + J3:, :2]
    shapes = ((B, TOTAL, N, 1), (B, OBS, N, 1), (B, TOTAL, N, J3, 1),
              (B, TOTAL, N, J2, 1), (B, 1, N, 1), (B, 1, N, 1),
              (B, 1, N, 1, 1), (B, 1, N, 1, 1))
    u = [_rand(gen, s, dev) for s in shapes]

    def keep(x, r):
        return (x > r).float()

    traj = traj * keep(u[0], c["mask_traj"])
    traj = torch.cat([traj[:, :OBS] * keep(u[1], c["mask_frame"]),
                      traj[:, OBS:]], 1)
    p3 = p3 * keep(u[2], c["mask_joints"]) * keep(u[6], c["mask_modality"])
    p2 = p2 * keep(u[3], c["mask_joints"]) * keep(u[7], c["mask_modality"])
    b3 = b3 * keep(u[4], c["mask_modality"])
    b2 = b2 * keep(u[5], c["mask_modality"])

    parts = [_lin(p, "fc_in_traj", traj) + p["pe_traj_time"][None, :, None]
             + p["pe_traj_id"][0],
             _lin(p, "fc_in_3dbb", b3[:, :OBS]) + p["pe_3dbb"][None, :, None],
             _lin(p, "fc_in_2dbb", b2[:, :OBS]) + p["pe_2dbb"][None, :, None],
             _lin(p, "fc_in_3dpose", p3[:, :OBS])
             + p["pe_3dpose"].reshape(OBS, J3, D)[None, :, None],
             _lin(p, "fc_in_2dpose", p2[:, :OBS])
             + p["pe_2dpose"].reshape(OBS, J2, D)[None, :, None]]
    seq = torch.cat([x.movedim(2, 1).reshape(B * N, -1, D) for x in parts],
                    1)
    h = seq
    for i in range(c["nlayers_local"]):
        h = _layer(p, f"local.{i}", h, None, c, gen)
    h = h + seq
    g_in = h[:, :TOTAL].reshape(B, N * TOTAL, D)
    mask = present.repeat_interleave(TOTAL, 1)
    g = g_in
    for i in range(c["nlayers_global"]):
        g = _layer(p, f"global.{i}", g, mask, c, gen)
    g = g + g_in
    primary = g.reshape(B, N, TOTAL, D)[:, 0]
    return _lin(p, "heads", primary).reshape(B, TOTAL, c["nmode"], 2)


def loss(p, vp, c, pc, batch, gen):
    """The step's total loss: WTA + weight × EmLoco."""
    obs, present, gt, pose, vel = batch
    pred = forward(p, c, obs, present, gen)[:, OBS:]          # (B,12,M,2)
    d = torch.linalg.vector_norm(pred - gt[:, :, None], dim=-1)
    wta = d.mean(1).min(-1).values.mean() * 100.0
    B, Fp, M, _ = pred.shape
    traj = pred.movedim(2, 1).reshape(B * M, Fp, 2)
    traj = torch.cat([torch.zeros_like(traj[:, :1]), traj], 1)
    zup = pose * torch.tensor([1.0, 1.0, -1.0], device=pose.device)
    v = valuenet.forward(vp, traj, zup.repeat_interleave(M, 0),
                         vel.repeat_interleave(M, 0))
    return wta + pc["valueloss_weight"] * torch.mean((v - 1.0) ** 2)


def train(params, vparams, c, pc, batches, gen):
    """The program's first steps, one a batch: (losses, the first moment
    after step 1, the clipped first gradient, params after the last)."""
    state = optim.zeros_state(params)
    losses, m1, g1 = [], None, None
    for batch in batches:
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        total = loss(p, vparams, c, pc, batch, gen)
        grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
        grads = optim.clip_global(grads, pc["grad_clip"])
        lr = optim.staircase_decay(state["count"], pc["lr"],
                                   pc["lr_decay_epochs"], pc["lr_decay"])
        params, state = optim.step({k: v.detach() for k, v in
                                    params.items()}, grads, state, lr)
        losses.append(float(total.detach()))
        if m1 is None:
            m1, g1 = dict(state["m"]), grads
    return losses, m1, g1, params
