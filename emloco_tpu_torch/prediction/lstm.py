"""LSTM trajectory-prediction baseline (port of
emloco_tpu/prediction/lstm.py; the reference's configs/jta_lstm.yaml).

The same call as TransMotion, (tokens, padding_mask) → (B, total_F, nmode,
2), so the trainer, the EmLoco loss, evaluation and the LocoVal filter
take it unchanged. An encoder LSTM reads the primary agent's observed xy
track; a decoder LSTM rolls out each mode autoregressively from the last
position, every mode feeding back its own velocity residuals (modes ride
the batch axis, row b·M + m is batch b, mode m).

The cells are flax's OptimizedLSTMCell: input kernels `ii`, `if`, `ig`,
`io` without bias, hidden kernels `hi`, `hf`, `hg`, `ho` with one;
i, f, o = σ(·), g = tanh(·), c′ = f·c + i·g, h′ = o·tanh(c′), and the
carry starts at zero.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import device as _device
from .model import TransMotionConfig, init_flax_families

GATES = "ifgo"


class LSTMCell(nn.Module):
    """flax OptimizedLSTMCell(features) over inputs of width `in_dim`."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        for g in GATES:
            self.add_module("i" + g, nn.Linear(in_dim, features, bias=False))
        for g in GATES:
            self.add_module("h" + g, nn.Linear(features, features))

    def forward(self, carry, x):
        c, h = carry
        z = {g: getattr(self, "i" + g)(x) + getattr(self, "h" + g)(h)
             for g in GATES}
        i, f, o = (torch.sigmoid(z[g]) for g in "ifo")
        c = f * c + i * torch.tanh(z["g"])
        h = o * torch.tanh(c)
        return (c, h), h


class LSTMPredictor(nn.Module):
    """Encoder-decoder LSTM over the primary agent's xy track."""

    def __init__(self, cfg: TransMotionConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        H = cfg.nhid
        self.enc = LSTMCell(H, H)
        self.dec = LSTMCell(H, H)
        self.in_proj = nn.Linear(2, H)
        self.out_proj = nn.Linear(H, 2)
        self.mode_emb = nn.Parameter(torch.empty(cfg.nmode, H))
        self.to(_device.resolve(device))
        self.init_parameters(generator)

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator | None = None):
        """flax's families; out_proj's kernel starts at zero, as the JAX
        module initializes it."""
        init_flax_families(self, generator)
        self.out_proj.weight.zero_()

    def forward(self, tokens, padding_mask, train: bool = False,
                limit_obs: int = 0, draws=None, gen=None, mesh=None):
        """tokens (B, in_F, N, J, 4) → (B, total_F, nmode, 2); `limit_obs`
        > 0 zeroes all but the last `limit_obs` observed positions. The
        model has no train-time masking or dropout: `train`, `draws`,
        `gen` and `mesh` are accepted and unused."""
        c = self.cfg
        B, in_F = tokens.shape[:2]
        out_F = c.total_frames - in_F
        xy = tokens[:, :, 0, 0, :2]                          # (B, in_F, 2)
        lim = limit_obs if limit_obs > 0 else in_F
        keep = torch.arange(in_F, device=xy.device) >= in_F - lim
        xy = torch.where(keep[None, :, None], xy, torch.zeros_like(xy))

        H, M = c.nhid, c.nmode
        zero = xy.new_zeros((B, H))
        carry = (zero, zero)
        for t in range(in_F):
            carry, _ = self.enc(carry, self.in_proj(xy[:, t]))

        last = xy[:, -1]
        dcarry = tuple(x.repeat_interleave(M, dim=0) for x in carry)
        cur = last.repeat_interleave(M, dim=0)               # (B·M, 2)
        inp = self.in_proj(cur) + self.mode_emb.repeat(B, 1)
        outs = []
        for _ in range(out_F):
            dcarry, h = self.dec(dcarry, inp)
            dv = self.out_proj(h) * c.output_scale           # (B·M, 2)
            outs.append(dv.reshape(B, M, 2))
            cur = cur + dv                                   # own feedback
            inp = self.in_proj(cur)
        vel = torch.stack(outs, dim=1)                       # (B,out_F,M,2)
        pred = last[:, None, None] + torch.cumsum(vel, dim=1)
        obs_part = xy[:, :, None].expand(B, in_F, M, 2)
        return torch.cat([obs_part, pred], dim=1)
