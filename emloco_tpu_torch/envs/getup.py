"""Getup variant: fall-state initialization and recovery episodes.

Port of emloco_tpu/envs/getup.py:
  * a bank of fall states is generated once at construction: randomly
    oriented humanoids dropped 0.6 m above the terrain with zero joint
    state, driven by fixed random actions for `fall_gen_steps` physics
    substeps (`_generate_fall_states`);
  * an auto-reset draws its env from the bank with probability
    `fall_init_prob`, moved to the freshly drawn spawn; fall resets and, with
    probability `recovery_episode_prob`, other resets start a recovery
    episode, whose first `recovery_steps` steps cannot terminate early;
  * `update_getup_schedule` ramps from always-fall-init to the target
    probabilities after `getup_update_epoch` epochs. The probabilities live
    in the state, as 0-d tensors.

The draws come from the env's torch.Generator; each is a function of its own
(`fall_bank_draw`, `getup_reset_draw`), apart from the pure functions of the
draws (`_fall_states`, `_getup_reset`), so that a test can feed the JAX
package's draws to them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kinematics import body_model as bm
from ..ops import quat
from ..parallel import mesh as pmesh
from ..physics import height_at, kinematic_state, step as physics_step
from .pedestrian_terrain import (EnvConfig, EnvState, PedestrianTerrainEnv,
                                 _select)


@dataclasses.dataclass(frozen=True)
class GetupEnvConfig(EnvConfig):
    recovery_episode_prob: float = 0.2
    recovery_steps: int = 60
    fall_init_prob: float = 0.1
    fall_gen_steps: int = 150
    # epochs of always-fall-init before the target probabilities
    getup_update_epoch: int = 5000


@dataclasses.dataclass(frozen=True)
class GetupEnvState(EnvState):
    recovery_counter: Optional[torch.Tensor] = None       # (N,) int32
    fall_init_prob: Optional[torch.Tensor] = None         # () f32
    recovery_episode_prob: Optional[torch.Tensor] = None  # () f32


def fall_bank_draw(env: PedestrianTerrainEnv, gen: torch.Generator, n: int):
    """The fall bank's draws, in this order: the standard normal (n, 4) that
    normalizes to the root orientations, the spawn points (n, 2) from the
    terrain's table, the actions (n, 23, 3) uniform in [-0.5, 0.5); n is
    the env's own rows of the whole env axis's draws under a mesh."""
    dev, mesh = env.device, env.mesh
    rot = pmesh.draw_rows(torch.randn, (n, 4), mesh, generator=gen,
                          device=dev)
    xy = env._sample_spawn(gen, n)
    act = pmesh.draw_rows(torch.rand, (n, bm.NUM_JOINTS, 3), mesh,
                          generator=gen, device=dev) - 0.5
    return rot, xy, act


def getup_reset_draw(gen: torch.Generator, n: int, device, mesh=None):
    """The auto-reset's two uniforms (n,) each: the fall-bank coin, then the
    recovery-episode coin (`mesh`: parallel.mesh.draw_rows)."""
    return tuple(pmesh.draw_rows(torch.rand, (n,), mesh, generator=gen,
                                 device=device) for _ in range(2))


class PedestrianTerrainGetupEnv(PedestrianTerrainEnv):
    """The fall bank lives on the device; resets mix standing and fall
    states."""

    def __init__(self, cfg: GetupEnvConfig, terrain, motion_lib, **kw):
        super().__init__(cfg, terrain, motion_lib, **kw)
        self.fall_bank = self._generate_fall_states(
            torch.Generator(device=self.device).manual_seed(1234))

    def update_getup_schedule(self, state: GetupEnvState, epoch: int,
                              update_epoch: int | None = None
                              ) -> GetupEnvState:
        """Always fall-init (and no recovery coin) up to `update_epoch`
        (default cfg.getup_update_epoch), the target probabilities after."""
        if update_epoch is None:
            update_epoch = self.cfg.getup_update_epoch
        early = epoch <= update_epoch
        return state.replace(
            fall_init_prob=torch.tensor(
                1.0 if early else self.cfg.fall_init_prob,
                device=self.device),
            recovery_episode_prob=torch.tensor(
                0.0 if early else self.cfg.recovery_episode_prob,
                device=self.device))

    def _generate_fall_states(self, gen: torch.Generator):
        return self._fall_states(*fall_bank_draw(self, gen, self.num_envs))

    @torch.no_grad()
    def _fall_states(self, rot, spawn_xy, actions):
        """Drop the humanoids of the draws and let them settle for
        fall_gen_steps substeps under PD targets actions·pd_action_scale."""
        cfg = self.cfg
        n = rot.shape[0]
        root_rot = quat.normalize(rot)
        ground = height_at(self.terrain, spawn_xy)
        root_pos = torch.cat([spawn_xy, (ground + 0.6)[:, None]], -1)
        local = quat.identity_like((n, bm.NUM_BODIES), device=self.device)
        local[:, 0] = root_rot
        st = kinematic_state(self.model, self.tree, root_pos, root_rot, local)
        pd = actions * self.pd_action_scale[None]
        for _ in range(cfg.fall_gen_steps // cfg.engine.n_substeps):
            st = physics_step(self.model, self.terrain, st, pd, cfg.engine,
                              self.tree)
        return st

    def _reset(self, generator: torch.Generator) -> GetupEnvState:
        base = super()._reset(generator)
        n = self.num_envs
        return GetupEnvState(
            **{f.name: getattr(base, f.name)
               for f in dataclasses.fields(base)},
            recovery_counter=torch.zeros((n,), dtype=torch.int32,
                                         device=self.device),
            fall_init_prob=torch.tensor(self.cfg.fall_init_prob,
                                        device=self.device),
            recovery_episode_prob=torch.tensor(
                self.cfg.recovery_episode_prob, device=self.device))

    def _auto_reset(self, state: GetupEnvState, done):
        new_state = super()._auto_reset(state, done)
        u_fall, u_rec = getup_reset_draw(state.rng, self.num_envs,
                                         self.device, self.mesh)
        return self._getup_reset(state, new_state, done, u_fall, u_rec)

    def _getup_reset(self, state: GetupEnvState, new_state: GetupEnvState,
                     done, u_fall, u_rec) -> GetupEnvState:
        """The base auto-reset's state `new_state` with the fall resets
        swapped in (u_fall below fall_init_prob, where `done`) and the
        recovery counters updated: set to recovery_steps on a fall or
        recovery reset, 0 on another reset, else one less (not below 0).
        A bank state is moved to its env's fresh spawn (xy, and z by the
        terrain height difference), and its AMP window and LocoVal inputs
        are taken from it."""
        cfg = self.cfg
        use_fall = (u_fall < state.fall_init_prob) & done
        bank = self.fall_bank
        bank_xy = bank.root_pos[:, :2]
        new_xy = new_state.physics.root_pos[:, :2]
        dz = height_at(self.terrain, new_xy) - height_at(self.terrain,
                                                         bank_xy)
        delta = torch.cat([new_xy - bank_xy, dz[:, None]], -1)
        fall = bank.replace(root_pos=bank.root_pos + delta,
                            body_x=bank.body_x + delta[:, None])
        physics = dataclasses.replace(fall, **{
            f.name: _select(use_fall, getattr(fall, f.name),
                            getattr(new_state.physics, f.name))
            for f in dataclasses.fields(fall)})
        amp_fall = self._amp_obs_single(physics)
        hist_fall = amp_fall[:, None].repeat(1, cfg.num_amp_obs_steps, 1)
        wp, pose, vel = self._capture_locoval_inputs(physics,
                                                     new_state.traj_verts)
        recov = (u_rec < state.recovery_episode_prob) & done
        start = (use_fall | recov) & done
        counter = torch.clamp(state.recovery_counter - 1, min=0)
        counter = torch.where(start, torch.full_like(counter,
                                                     cfg.recovery_steps),
                              counter)
        counter = torch.where(done & ~start, torch.zeros_like(counter),
                              counter)
        return new_state.replace(
            physics=physics,
            amp_obs_hist=_select(use_fall, hist_fall, new_state.amp_obs_hist),
            waypoint_traj=_select(use_fall, wp, new_state.waypoint_traj),
            init_pose=_select(use_fall, pose, new_state.init_pose),
            init_vel=_select(use_fall, vel, new_state.init_vel),
            recovery_counter=counter)

    def _termination_allowed(self, state: GetupEnvState):
        return state.recovery_counter <= 0
