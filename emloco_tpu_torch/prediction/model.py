"""Social-Transmotion-style trajectory predictor (port of
emloco_tpu/prediction/model.py; reference
social-transmotion/model_jta.py:130-336, JRDB subclass model_jrdb.py:12).

A dual transformer over visual-cue tokens:
  * tokens per person per frame: trajectory xy (1), 3D box (1), 2D box (1),
    3D pose joints (24), 2D pose joints (22); 4 feature channels
  * the local (CMT) encoder over each person's token sequence: 21 traj
    tokens (9 observed, 12 padded with the last) + 9·(1+1+24+22) cue
    tokens = 453 tokens (246 for the JRDB streams)
  * the global (ST) encoder across people over the 21·N traj tokens
  * learned positional embeddings, train-time random masking of
    trajectories, joints, whole modalities and frames, `limit_obs`
    evaluation masking, local and global residuals ×output_scale
  * nmode linear heads, one Dense(2·nmode), on the primary agent

The encoder layers are post-LN and written out as flax writes them:
q, k, v projections, the query scaled by 1/√Dh, padded keys' logits set to
the dtype's finite minimum (a fully masked row stays finite), softmax in
the input dtype, the value product and the output projection; LayerNorm
eps 1e-5. flax scans each encoder over a stack of layer parameters; here
each is an nn.ModuleList of its layers (`convert.transmotion_state_dict`
carries the weights across).

Random streams: `jax.random` cannot be reproduced in torch. In train mode
the model takes the eight uniforms of the masking (`mask_draws`, in
model_jta's order) as `draws`, or draws them from `gen`, and draws every
dropout keep-mask from `gen` after them, in forward order: per encoder
layer the attention weights, after attention, inside the FF, after the FF.
A draw is made on the generator's device and moved to the model's, so a
CPU generator reproduces a CPU run's draws on the card. Under a batch-axis
`mesh` (parallel.mesh) each draw is the whole batch's and the rank keeps
its rows: every drawn tensor leads with the batch (B, or B·N people
b-major), so a rank's rows are its block of that axis.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .. import device as _device
from ..parallel import mesh as pmesh


@dataclasses.dataclass(frozen=True)
class TransMotionConfig:
    obs_frames: int = 9
    total_frames: int = 21          # obs + pred
    nhid: int = 128                 # jta_all_visual_cues.yaml: 128
    nhead: int = 4
    dim_ff: int = 1024
    nlayers_local: int = 6
    nlayers_global: int = 3
    nmode: int = 20                 # multi-modal heads
    dropout: float = 0.1
    output_scale: float = 1.0
    num_3dpose: int = 24
    num_2dpose: int = 22
    multi_modal: bool = True
    # the JRDB variant (model_jrdb.py:12-145) has no 3D-box and no 2D-pose
    # stream: with these off the local encoder runs its 246-token sequence
    # and has no parameters for them; token input keeps the superset layout
    use_3dbb: bool = True
    use_2dpose: bool = True
    # "transmotion" | "lstm" (configs/jta_lstm.yaml)
    arch: str = "transmotion"
    # train-time mask ratios (model_jta.py:207-243)
    mask_traj: float = 0.2
    mask_joints: float = 0.2
    mask_modality: float = 0.3
    mask_frame: float = 0.2

    @property
    def tokens_per_frame(self):
        return 3 + self.num_3dpose + self.num_2dpose

    @property
    def pred_frames(self):
        return self.total_frames - self.obs_frames


def _uniform(gen: torch.Generator | None, shape, device,
             mesh=None) -> torch.Tensor:
    """Uniform draws on `gen`'s device (torch's default generator on
    `device` without one), moved to `device`; `mesh`: this rank's rows of
    the whole batch's draw (parallel.mesh.draw_rows)."""
    where = device if gen is None else gen.device
    return pmesh.draw_rows(torch.rand, shape, mesh, generator=gen,
                           device=where).to(device)


def mask_draws(gen: torch.Generator, cfg: TransMotionConfig, B: int, N: int,
               device=None, mesh=None) -> list:
    """The eight uniform draws of the train-time masking, in model_jta's
    order and shapes (emloco_tpu/prediction/model.py:183-203): trajectory
    (B,F,N,1), frame (B,in_F,N,1), 3D joints (B,F,N,J3,1), 2D joints
    (B,F,N,J2,1), then per person the 3D box, 2D box (B,1,N,1), 3D pose and
    2D pose (B,1,N,1,1) modalities."""
    Fr, in_F = cfg.total_frames, cfg.obs_frames
    shapes = ((B, Fr, N, 1), (B, in_F, N, 1), (B, Fr, N, cfg.num_3dpose, 1),
              (B, Fr, N, cfg.num_2dpose, 1), (B, 1, N, 1), (B, 1, N, 1),
              (B, 1, N, 1, 1), (B, 1, N, 1, 1))
    return [_uniform(gen, s, device, mesh) for s in shapes]


def apply_train_masks(cfg: TransMotionConfig, streams: dict, draws) -> dict:
    """The train-time masking of the five streams (traj (B,F,N,2), 3dbb,
    2dbb (B,F,N,4), 3dpose (B,F,N,J3,3), 2dpose (B,F,N,J2,2)) by the eight
    uniforms of `mask_draws`: each entry kept where its draw exceeds the
    ratio (model_jta.py:207-243)."""
    s = dict(streams)
    in_F = cfg.obs_frames

    def keep(u, ratio):
        return (u > ratio).to(s["traj"].dtype)

    s["traj"] = s["traj"] * keep(draws[0], cfg.mask_traj)
    s["traj"] = torch.cat([s["traj"][:, :in_F] * keep(draws[1],
                                                      cfg.mask_frame),
                           s["traj"][:, in_F:]], dim=1)
    s["3dpose"] = s["3dpose"] * keep(draws[2], cfg.mask_joints)
    s["2dpose"] = s["2dpose"] * keep(draws[3], cfg.mask_joints)
    if cfg.use_3dbb:
        s["3dbb"] = s["3dbb"] * keep(draws[4], cfg.mask_modality)
    s["2dbb"] = s["2dbb"] * keep(draws[5], cfg.mask_modality)
    s["3dpose"] = s["3dpose"] * keep(draws[6], cfg.mask_modality)
    if cfg.use_2dpose:
        s["2dpose"] = s["2dpose"] * keep(draws[7], cfg.mask_modality)
    return s


def dropout(x: torch.Tensor, rate: float, train: bool,
            gen: torch.Generator | None, mesh=None) -> torch.Tensor:
    """flax's Dropout: the identity in eval mode; in train mode keep each
    entry where a uniform draw from `gen` is below 1 − rate and scale the
    kept ones by 1/(1 − rate)."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = _uniform(gen, x.shape, x.device, mesh) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Attention(nn.Module):
    """flax's MultiHeadDotProductAttention (self-attention): q/k/v and the
    output projection as nn.Linear over the H·Dh features."""

    def __init__(self, nhid: int, nhead: int, dropout_rate: float):
        super().__init__()
        self.nhead = nhead
        self.rate = dropout_rate
        for name in ("query", "key", "value", "out"):
            self.add_module(name, nn.Linear(nhid, nhid))

    def forward(self, x, key_padding_mask=None, train=False, gen=None,
                mesh=None):
        B, S, D = x.shape
        H = self.nhead
        Dh = D // H
        q = self.query(x).reshape(B, S, H, Dh) / math.sqrt(Dh)
        k = self.key(x).reshape(B, S, H, Dh)
        v = self.value(x).reshape(B, S, H, Dh)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if key_padding_mask is not None:
            logits = logits.masked_fill(~key_padding_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        w = torch.softmax(logits, dim=-1)
        w = dropout(w, self.rate, train, gen, mesh)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, S, D)
        return self.out(o)


class EncoderLayer(nn.Module):
    """Post-LN transformer encoder layer (flax EncoderLayer)."""

    def __init__(self, nhid: int, nhead: int, dim_ff: int, dropout_rate):
        super().__init__()
        self.rate = dropout_rate
        self.attn = Attention(nhid, nhead, dropout_rate)
        self.norm1 = nn.LayerNorm(nhid, eps=1e-5)
        self.ff1 = nn.Linear(nhid, dim_ff)
        self.ff2 = nn.Linear(dim_ff, nhid)
        self.norm2 = nn.LayerNorm(nhid, eps=1e-5)

    def forward(self, x, key_padding_mask=None, train=False, gen=None,
                mesh=None):
        a = self.attn(x, key_padding_mask, train, gen, mesh)
        x = self.norm1(x + dropout(a, self.rate, train, gen, mesh))
        h = torch.relu(self.ff1(x))
        h = self.ff2(dropout(h, self.rate, train, gen, mesh))
        return self.norm2(x + dropout(h, self.rate, train, gen, mesh))


def encoder_stack(nlayers, nhid, nhead, dim_ff, rate) -> nn.ModuleList:
    return nn.ModuleList(EncoderLayer(nhid, nhead, dim_ff, rate)
                         for _ in range(nlayers))


def run_stack(stack: nn.ModuleList, x, key_padding_mask=None, train=False,
              gen=None, mesh=None):
    for layer in stack:
        x = layer(x, key_padding_mask, train, gen, mesh)
    return x


def lecun_normal_(w: torch.Tensor, fan_in: int, gen) -> None:
    """flax's lecun_normal: a normal truncated at ±2σ, scaled so that the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.mul_(std)


@torch.no_grad()
def init_flax_families(module: nn.Module, gen: torch.Generator | None,
                       embeddings=("pe_", "mode_emb")) -> None:
    """flax's default initializers for a module tree: lecun-normal Linear
    weights, zero biases, unit LayerNorm scales, and N(0, 0.02²) for the
    parameters whose names start with `embeddings`; parameters in
    named_parameters order, each drawn from `gen`."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rpartition(".")[0]) \
            if "." in name else module
        if name.startswith(embeddings):
            nn.init.normal_(p, 0.0, 0.02, generator=gen)
        elif isinstance(owner, nn.LayerNorm):
            nn.init.ones_(p) if leaf == "weight" else nn.init.zeros_(p)
        elif leaf == "bias":
            nn.init.zeros_(p)
        else:
            lecun_normal_(p, p.shape[1], gen)


class TransMotion(nn.Module):
    """TransMotion (flax TransMotion): forward(tokens, padding_mask, train,
    limit_obs, draws, gen) → (B, total_F, nmode, 2) for person 0."""

    def __init__(self, cfg: TransMotionConfig = TransMotionConfig(),
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        c = self.cfg = cfg
        D, in_F, Fr = c.nhid, c.obs_frames, c.total_frames
        self.fc_in_traj = nn.Linear(2, D)
        self.pe_traj_time = nn.Parameter(torch.empty(Fr, D))
        self.pe_traj_id = nn.Parameter(torch.empty(1, D))
        if c.use_3dbb:
            self.fc_in_3dbb = nn.Linear(4, D)
            self.pe_3dbb = nn.Parameter(torch.empty(in_F, D))
        self.fc_in_2dbb = nn.Linear(4, D)
        self.pe_2dbb = nn.Parameter(torch.empty(in_F, D))
        self.fc_in_3dpose = nn.Linear(3, D)
        self.pe_3dpose = nn.Parameter(torch.empty(in_F * c.num_3dpose, D))
        if c.use_2dpose:
            self.fc_in_2dpose = nn.Linear(2, D)
            self.pe_2dpose = nn.Parameter(
                torch.empty(in_F * c.num_2dpose, D))
        self.add_module("local", encoder_stack(
            c.nlayers_local, D, c.nhead, c.dim_ff, c.dropout))
        self.add_module("global", encoder_stack(
            c.nlayers_global, D, c.nhead, c.dim_ff, c.dropout))
        if c.multi_modal:
            self.heads = nn.Linear(D, 2 * c.nmode)
        else:
            self.fc_out_traj = nn.Linear(D, 2)
        self.to(_device.resolve(device))
        self.init_parameters(generator)

    def init_parameters(self, generator: torch.Generator | None = None):
        init_flax_families(self, generator)

    def streams(self, tokens):
        """The five streams over all frames, the future padded with the
        last observed frame (model_jta.py:199-203)."""
        c = self.cfg
        out_F = c.total_frames - tokens.shape[1]
        pad = tokens[:, -1:].expand(-1, out_F, -1, -1, -1)
        tgt = torch.cat([tokens, pad], dim=1)               # (B,F,N,J,K)
        p3 = 3 + c.num_3dpose
        return {"traj": tgt[:, :, :, 0, :2], "3dbb": tgt[:, :, :, 1, :4],
                "2dbb": tgt[:, :, :, 2, :4],
                "3dpose": tgt[:, :, :, 3:p3, :3],
                "2dpose": tgt[:, :, :, p3:p3 + c.num_2dpose, :2]}

    def forward(self, tokens, padding_mask, train: bool = False,
                limit_obs: int = 0, draws=None,
                gen: torch.Generator | None = None, mesh=None):
        """tokens (B, in_F, N, J, 4), padding_mask (B, N) True = present.
        `limit_obs` > 0 keeps only the last `limit_obs` observed frames
        (≤ 0 keeps all); `draws` the masking's uniforms in train mode."""
        c = self.cfg
        B, in_F, N = tokens.shape[:3]
        Fr, D = c.total_frames, c.nhid
        s = self.streams(tokens)
        if train:
            if draws is None:
                draws = mask_draws(gen, c, B, N, tokens.device, mesh)
            s = apply_train_masks(c, s, draws)

        # keep only the last `limit_obs` observed frames (model_jta.py:
        # 266-275); the padded future frames stay
        lim = limit_obs if limit_obs > 0 else in_F
        t_idx = torch.arange(Fr, device=tokens.device)
        keep = ((t_idx >= in_F - lim) | (t_idx >= in_F)).to(tokens.dtype)
        keep = keep[None, :, None, None]
        s = {"traj": s["traj"] * keep, "3dbb": s["3dbb"] * keep,
             "2dbb": s["2dbb"] * keep, "3dpose": s["3dpose"] * keep[..., None],
             "2dpose": s["2dpose"] * keep[..., None]}

        traj_f = (self.fc_in_traj(s["traj"]) + self.pe_traj_time[None, :, None]
                  + self.pe_traj_id[0])                     # (B,F,N,D)
        parts = [traj_f]
        if c.use_3dbb:
            parts.append(self.fc_in_3dbb(s["3dbb"][:, :in_F])
                         + self.pe_3dbb[None, :, None])
        parts.append(self.fc_in_2dbb(s["2dbb"][:, :in_F])
                     + self.pe_2dbb[None, :, None])
        parts.append(self.fc_in_3dpose(s["3dpose"][:, :in_F])
                     + self.pe_3dpose.reshape(in_F, c.num_3dpose, D)[
                         None, :, None])
        if c.use_2dpose:
            parts.append(self.fc_in_2dpose(s["2dpose"][:, :in_F])
                         + self.pe_2dpose.reshape(in_F, c.num_2dpose, D)[
                             None, :, None])
        # per person: (B, T, N, …, D) → (B·N, T·…, D), in the reference's
        # stream order (model_jta.py:309, model_jrdb.py:118)
        seq = torch.cat([x.movedim(2, 1).reshape(B * N, -1, D)
                         for x in parts], dim=1)

        h = run_stack(getattr(self, "local"), seq, None, train, gen, mesh)
        h = h * c.output_scale + seq                        # local residual

        g_in = h[:, :Fr].reshape(B, N * Fr, D)
        mask = padding_mask.repeat_interleave(Fr, dim=1)    # (B, N·F)
        g = run_stack(getattr(self, "global"), g_in, mask, train, gen, mesh)
        g = g * c.output_scale + g_in                       # global residual
        primary = g.reshape(B, N, Fr, D)[:, 0]              # (B,F,D)
        if c.multi_modal:
            return self.heads(primary).reshape(B, Fr, c.nmode, 2)
        return self.fc_out_traj(primary)[:, :, None]
