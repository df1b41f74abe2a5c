"""Hand-height variant: trajectory following + per-hand height targets.

Port of emloco_tpu/envs/hand_task.py: the task observation gains the two
target heights right after the trajectory samples, the mirror swaps them,
and the reward is 0.6·exp(−2‖Δxy‖²) + 0.4·exp(−6·Σ(hand height above the
root − target)²). The targets are drawn uniform in [0, 1) at each reset,
from the env's torch.Generator through `hand_target_draw`, a function of its
own so that a test can feed the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kinematics import body_model as bm
from ..parallel import mesh as pmesh
from ..physics import body_frame_state
from . import traj_gen
from .pedestrian_terrain import EnvState, PedestrianTerrainEnv

HAND_IDS = np.array([bm.BODY_NAMES.index("L_Hand"),
                     bm.BODY_NAMES.index("R_Hand")])


@dataclasses.dataclass(frozen=True)
class HandEnvState(EnvState):
    hand_targets: Optional[torch.Tensor] = None   # (N, 2) relative heights


def hand_target_draw(gen: torch.Generator, n: int, device,
                     mesh=None) -> torch.Tensor:
    """Fresh hand targets (n, 2), uniform in [0, 1) (`mesh`:
    parallel.mesh.draw_rows)."""
    return pmesh.draw_rows(torch.rand, (n, 2), mesh, generator=gen,
                           device=device)


class PedestrianTerrainHandEnv(PedestrianTerrainEnv):

    @property
    def _task_extra_dim(self):
        return 2

    def _reset(self, generator: torch.Generator) -> HandEnvState:
        base = super()._reset(generator)
        return HandEnvState(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(base)},
            hand_targets=hand_target_draw(generator, self.num_envs,
                                          self.device, self.mesh))

    def _task_obs(self, state: HandEnvState):
        base = super()._task_obs(state)
        S = self.cfg.num_traj_samples
        return torch.cat([base[:, :2 * S], state.hand_targets,
                          base[:, 2 * S:]], -1)

    def _flip_task_extra(self, extra):
        # the mirrored body swaps the left and right hand targets
        return extra.flip(-1)

    def _auto_reset(self, state: HandEnvState, done):
        new_state = super()._auto_reset(state, done)
        fresh = hand_target_draw(state.rng, self.num_envs, self.device,
                                 self.mesh)
        return new_state.replace(hand_targets=torch.where(
            done[:, None], fresh, state.hand_targets))

    def _reward(self, state: HandEnvState, physics, progress, pd_target):
        cfg = self.cfg
        times = progress.float() * cfg.dt
        tar = traj_gen.calc_pos(state.traj_verts, times, cfg.traj.episode_dur)
        pos, _, _, _ = body_frame_state(self.model, physics)
        root = pos[:, 0]
        loc_r = torch.exp(-2.0 * torch.sum((tar[:, :2] - root[:, :2]) ** 2,
                                           -1))
        hand_rel = pos[:, HAND_IDS, 2] - root[:, None, 2]
        hand_r = torch.exp(-6.0 * torch.sum(
            (hand_rel - state.hand_targets) ** 2, -1))
        reward = 0.6 * loc_r + 0.4 * hand_r
        return reward, torch.stack([loc_r, hand_r], -1)
