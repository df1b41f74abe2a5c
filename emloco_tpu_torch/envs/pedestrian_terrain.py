"""HumanoidPedestrianTerrain — the main EmLoco environment.

Port of emloco_tpu/envs/pedestrian_terrain.py: trajectory following over
procedural terrain with a height-map sensor, location + power reward,
contact/height early termination and motion-library resets with random
heading, with the auto-reset done inside `step` by per-env selects.

    reset(generator)       → EnvState
    step(state, actions)   → (EnvState, StepOutput)

The sensor is a square grid, a forward fan ("fov") or a forward square
("square_fov"), of heights or (velocity_map) of [height, vx, vy]; with
group_obs the envs form groups of consecutive envs that spawn clustered,
each env observes its 5 nearest group members, and the velocity map stamps
them in. Fault injection adds action noise before the physics step, root
pushes and projectile hits after it, and observation noise after the
auto-reset. Hard-negative motion sampling keeps per-motion episode counts
in the state and refreshes the motions' sampling weights once an epoch
(`apply_hard_negative_update`).

Training adds the left/right mirror of an observation (`observe_flipped`
from the state, `observe_flipped_from` in feature space), the observation
under hypothetical trajectory samples (`observe_with_traj`) and the AMP
demo fetch from the motion library.

The getup and hand-task variants (envs/getup.py, envs/hand_task.py)
override the hooks `_task_extra_dim` (a task-obs insert after the
trajectory samples) with `_flip_task_extra` (its mirror),
`_termination_allowed`, `reset`, `_auto_reset` and `_reward`.

Random draws come from the torch.Generator the caller passes to `reset`; it
travels in EnvState.rng and advances in place. Each perturbation's draw is a
function of its own (`action_noise_draw`, `push_draw`, `projectile_draw`,
`obs_noise_draw`), apart from the pure function that applies it.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import device as _device
from ..kinematics import body_model as bm
from ..kinematics import motion_lib as ml
from ..ops import quat
from ..parallel import mesh as pmesh
from ..physics import (
    EngineConfig,
    Heightfield,
    PhysicsState,
    body_frame_state,
    build_model,
    default_tree,
    height_at,
    joint_state,
    kinematic_state,
    step as physics_step,
)
from ..struct import TensorStruct
from ..utils.profiling import annotate
from . import observations as obs
from . import traj_gen


@dataclasses.dataclass(frozen=True)
class DRConfig:
    """Scheduled physical-property domain randomization: per-env scales on
    mass/PD gains/friction and an additive contact rest offset, resampled at
    reset at most every `frequency` env steps, ramped over `schedule_steps`."""

    enabled: bool = False
    mass_range: tuple = (0.8, 1.2)
    kp_range: tuple = (0.85, 1.15)
    kd_range: tuple = (0.85, 1.15)
    friction_range: tuple = (0.7, 1.3)
    rest_offset_range: tuple = (-0.005, 0.005)
    frequency: int = 128
    schedule_steps: int = 0


NUM_DR_PROPS = 5  # [mass, kp, kd, friction, rest_offset]
# the crowd observation's width: 5 neighbours × (10 joints + root vel) × 3
GROUP_OBS_DIM = 5 * 11 * 3


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    num_envs: int = 64
    episode_length: int = 168
    num_traj_samples: int = 15
    traj_sample_timestep: float = 0.4
    # read by no env step: LocoVal latches at ValueTrainConfig.step_to_pred
    step_to_pred: int = 144
    sensor_extent: float = 2.0
    sensor_res: int = 32
    sensor_shape: str = "square"
    height_meas_scale: float = 5.0
    terrain_obs: bool = True
    power_reward: bool = True
    power_coefficient: float = 5e-4
    location_coefficient: float = 1.0
    fail_dist: float = 4.0
    termination_height: float = 0.15
    enable_early_termination: bool = True
    contact_force_threshold: float = 1.0
    num_amp_obs_steps: int = 15
    random_heading: bool = True
    num_waypoints: int = 13
    freeze_toe: bool = True
    freeze_hand: bool = True
    ref_state_init_prob: float = 0.9
    hard_negative: bool = False
    hard_negative_temp: float = 0.2
    has_shape_obs: bool = True
    has_limb_weight_obs: bool = False
    group_obs: bool = False
    group_size: int = 128
    group_spawn_spread: float = 8.0   # half-width of the spawn jitter, m
    velocity_map: bool = False
    obs_noise_std: float = 0.0
    action_noise_std: float = 0.0
    push_interval: int = 0            # 0 = off
    push_vel: float = 1.0
    projectile_interval: int = 0      # 0 = off
    projectile_impulse: float = 3.0   # N·s
    dr: DRConfig = DRConfig()
    traj: traj_gen.TrajConfig = traj_gen.TrajConfig(
        episode_dur=2 * 168 / 30.0)
    engine: EngineConfig = EngineConfig()

    def __post_init__(self):
        if self.sensor_shape not in obs.SENSOR_GRIDS:
            raise ValueError(f"unknown sensor_shape {self.sensor_shape!r}")
        if self.group_obs and self.num_envs % self.obs_group_size:
            # the groups are consecutive envs of equal size
            raise ValueError(
                f"group_obs needs num_envs a multiple of the group size: "
                f"num_envs={self.num_envs}, group_size={self.group_size}")

    @property
    def obs_group_size(self):
        return min(self.group_size, self.num_envs)

    @property
    def dt(self):
        return self.engine.control_dt

    @property
    def self_obs_dim(self):
        return (obs.SELF_OBS_DIM + 11 * self.has_shape_obs
                + 10 * self.has_limb_weight_obs)

    @property
    def num_sensor_points(self):
        return len(obs.SENSOR_GRIDS[self.sensor_shape](self.sensor_extent,
                                                       self.sensor_res))

    @property
    def task_obs_dim(self):
        d = self.num_traj_samples * 2
        if self.terrain_obs:
            d += self.num_sensor_points * (3 if self.velocity_map else 1)
        if self.group_obs:
            d += GROUP_OBS_DIM
        return d

    @property
    def obs_dim(self):
        return self.self_obs_dim + self.task_obs_dim

    @property
    def amp_obs_per_step(self):
        return (obs.AMP_OBS_DIM + 11 * self.has_shape_obs
                + 10 * self.has_limb_weight_obs)

    @property
    def num_actions(self):
        return bm.NUM_DOF


@dataclasses.dataclass(frozen=True)
class EnvState(TensorStruct):
    physics: PhysicsState
    traj_verts: torch.Tensor       # (N, V, 3)
    inverted: torch.Tensor         # (N,) bool — heading-inverted real path
    progress: torch.Tensor         # (N,) int32
    reset_buf: torch.Tensor        # (N,) bool
    terminate_buf: torch.Tensor    # (N,) bool
    rng: torch.Generator
    amp_obs_hist: torch.Tensor     # (N, S, amp_dim) newest at index 0
    waypoint_traj: torch.Tensor    # (N, W, 2) LocoVal inputs at reset
    init_pose: torch.Tensor        # (N, 24, 3)
    init_vel: torch.Tensor         # (N, 2)
    dr_scales: torch.Tensor        # (N, NUM_DR_PROPS)
    dr_clock: torch.Tensor         # () int32
    dr_last: torch.Tensor          # (N,) int32
    # hard-negative motion sampling, None unless cfg.hard_negative
    motion_weights: Optional[torch.Tensor] = None   # (M,) live probabilities
    cur_mid: Optional[torch.Tensor] = None          # (N,) int32 episode motion
    motion_sampled: Optional[torch.Tensor] = None   # (M,) episodes finished
    motion_term: Optional[torch.Tensor] = None      # (M,) early terminations
    motion_succ: Optional[torch.Tensor] = None      # (M,) success-rate estimate


@dataclasses.dataclass(frozen=True)
class StepOutput(TensorStruct):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor             # reset (terminated | truncated)
    terminated: torch.Tensor       # early termination only
    amp_obs: torch.Tensor          # (N, S·amp_dim) flattened window
    reward_raw: torch.Tensor       # (N, 2) [location, power]


def _select(done, a, b):
    """Per-env select along the leading axis."""
    return torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def action_noise_draw(gen: torch.Generator, shape, device,
                      mesh=None) -> torch.Tensor:
    """The standard normal behind the action noise (`mesh`: this rank's
    rows of the whole env axis's draw, `parallel.mesh.draw_rows`, as in
    every draw below)."""
    return pmesh.draw_rows(torch.randn, shape, mesh, generator=gen,
                           device=device)


def push_draw(gen: torch.Generator, n: int, device,
              mesh=None) -> torch.Tensor:
    """The standard normal (n, 3) behind the root pushes."""
    return pmesh.draw_rows(torch.randn, (n, 3), mesh, generator=gen,
                           device=device)


def projectile_draw(gen: torch.Generator, n: int, device, mesh=None):
    """The draws behind the projectile hits: the body hit (n,) and the
    standard normal (n, 3) behind the impulse direction."""
    body = pmesh.draw_rows(torch.randint, (n,), mesh, 0, bm.NUM_BODIES,
                           generator=gen, device=device)
    return body, pmesh.draw_rows(torch.randn, (n, 3), mesh, generator=gen,
                                 device=device)


def obs_noise_draw(gen: torch.Generator, shape, device,
                   mesh=None) -> torch.Tensor:
    """The standard normal behind the observation noise."""
    return pmesh.draw_rows(torch.randn, shape, mesh, generator=gen,
                           device=device)


def push_kick(u, hit, raw, push_vel: float):
    """u with the root's linear velocity kicked by push_vel·raw (vertical
    component at a fifth) where `hit`."""
    dv = push_vel * raw * torch.tensor([1.0, 1.0, 0.2], device=raw.device)
    u = u.clone()
    u[:, 0:3] += torch.where(hit[:, None], dv, 0.0)
    return u


def projectile_kick(u, hit, body, raw_dir, impulse: float, body_x, mass_tot):
    """u with a projectile's impulse applied where `hit`: a mostly
    horizontal direction (vertical draw at 0.3, normalized) times `impulse`
    gives the root a linear kick impulse/mass and an angular kick (r ×
    impulse)/(0.15·mass), r the lever arm from the root to the body hit."""
    d = raw_dir * torch.tensor([1.0, 1.0, 0.3], device=raw_dir.device)
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-8)
    imp = impulse * d
    xb = body_x[torch.arange(body_x.shape[0], device=body_x.device), body]
    r = xb - body_x[:, 0]
    dv = imp / mass_tot
    dw = quat.cross(r, imp) / (mass_tot * 0.15)
    u = u.clone()
    u[:, 0:3] += torch.where(hit[:, None], dv, 0.0)
    u[:, 3:6] += torch.where(hit[:, None], dw, 0.0)
    return u


class PedestrianTerrainEnv:
    """Holds the static members (model, terrain, motion library, config).

    The bodies are `params` when given, else built on the env's device from
    `betas` (cfg.num_envs, 16), zeros by default; `params` wins when both
    are given, as in the JAX package.

    With a `mesh` (parallel.mesh.Mesh) of R ranks the env holds this rank's
    block of cfg.num_envs envs (`num_envs` = cfg.num_envs / R): the bodies
    are those of all cfg.num_envs envs, of which it keeps its rows;
    its first state is its part of the whole env axis's reset (`reset`),
    every draw over the env axis in a step is made for all envs and the
    rank keeps its rows, and the per-motion hard-negative counts are summed
    over the ranks, so the R ranks step the one-rank env's rows."""

    def __init__(self, cfg: EnvConfig, terrain: Heightfield,
                 motion_lib: ml.MotionLib,
                 real_traj_bank: Optional[torch.Tensor] = None,
                 params: Optional[bm.BodyParams] = None, device=None,
                 mesh: Optional[pmesh.Mesh] = None, betas=None):
        self.device = dev = _device.resolve(device)
        self.cfg = cfg
        self.mesh = mesh
        ranks = 1 if mesh is None else mesh.size
        if cfg.num_envs % ranks:
            raise ValueError(f"num_envs={cfg.num_envs} is not divisible by "
                             f"the {ranks}-rank mesh")
        if cfg.group_obs:
            obs.check_group_shards(cfg.num_envs, cfg.obs_group_size, ranks)
        self.num_envs = cfg.num_envs // ranks
        self.terrain = terrain.to(dev)
        self.motion_lib = motion_lib.to(dev)
        self.tree = default_tree()
        if params is None:
            if betas is None:
                betas = np.zeros((cfg.num_envs, 16), np.float32)
            params = bm.build_body_params(betas, device=dev)
        # every env's bodies: the whole env axis's reset (`reset`) needs them
        self._all_params = params if ranks > 1 else None
        if ranks > 1:
            rows = mesh.block(cfg.num_envs)
            params = params.map_tensors(lambda t: t[rows])
        self._bind_params(params)
        self.real_traj_bank = (None if real_traj_bank is None
                               else real_traj_bank.to(dev))
        grid = obs.SENSOR_GRIDS[cfg.sensor_shape](cfg.sensor_extent,
                                                  cfg.sensor_res)
        self.sensor_grid = torch.as_tensor(grid, device=dev)
        # the y-mirror of the sensor grid, an index permutation
        self.sensor_flip_perm = torch.as_tensor(obs.grid_flip_perm(grid),
                                                device=dev)
        # feature-space self-obs mirror (signed permutation)
        fidx, fsign = obs.build_self_obs_flip(cfg.self_obs_dim)
        self._flip_self_idx = torch.as_tensor(fidx, device=dev)
        self._flip_self_sign = torch.as_tensor(fsign, device=dev)
        # PD action mapping: ±1.2·max|limit| clamped to π, knee y-scale 5
        lim = self.params.joint_limit[0].cpu().numpy()
        scale = np.minimum(1.2 * np.abs(lim).max(-1, keepdims=True), np.pi)
        scale = np.broadcast_to(scale, lim.shape).copy()
        for knee in ("L_Knee", "R_Knee"):
            scale[bm.BODY_NAMES.index(knee) - 1, 1] = 5.0
        self.pd_action_scale = torch.as_tensor(scale, device=dev)
        frozen = []
        if cfg.freeze_toe:
            frozen += [bm.BODY_NAMES.index("L_Toe") - 1,
                       bm.BODY_NAMES.index("R_Toe") - 1]
        if cfg.freeze_hand:
            frozen += [bm.BODY_NAMES.index("L_Hand") - 1,
                       bm.BODY_NAMES.index("R_Hand") - 1]
        mask = np.ones((bm.NUM_JOINTS, 1), np.float32)
        mask[frozen] = 0.0
        self.action_mask = torch.as_tensor(mask, device=dev)
        self._contact_ids = torch.as_tensor(obs.CONTACT_BODY_IDS, device=dev)
        self._key_ids = torch.as_tensor(obs.KEY_BODY_IDS, device=dev)
        self._head = self.tree.index("Head")

    def _bind_params(self, params: bm.BodyParams):
        """The env's bodies (one row an env) and what is derived from them:
        the physics model, the limb weights and the shape observations."""
        cfg = self.cfg
        self.params = params.to(self.device)
        self.model = build_model(self.params)
        # limb weight obs: per-group mass fractions + scaled group mass
        mass = self.params.mass
        groups = [
            ["L_Hip", "L_Knee", "L_Ankle", "L_Toe"],
            ["R_Hip", "R_Knee", "R_Ankle", "R_Toe"],
            ["Pelvis", "Torso", "Spine", "Chest", "Neck", "Head"],
            ["L_Thorax", "L_Shoulder", "L_Elbow", "L_Wrist", "L_Hand"],
            ["R_Thorax", "R_Shoulder", "R_Elbow", "R_Wrist", "R_Hand"],
        ]
        gm = torch.stack([mass[:, [bm.BODY_NAMES.index(n) for n in g]].sum(-1)
                          for g in groups], -1)
        total = mass.sum(-1, keepdim=True)
        self.limb_weights = torch.cat([gm / total, gm / 20.0], -1)
        self._obs_betas = self.params.betas if cfg.has_shape_obs else None
        self._obs_limbw = (self.limb_weights if cfg.has_limb_weight_obs
                           else None)
        self._mass_tot = mass.sum(-1, keepdim=True)

    @property
    def _task_extra_dim(self):
        """Width of a variant's task-obs insert after the trajectory
        samples (the hand targets); 0 here."""
        return 0

    @property
    def task_obs_dim(self):
        return self.cfg.task_obs_dim + self._task_extra_dim

    @property
    def obs_dim(self):
        return self.cfg.self_obs_dim + self.task_obs_dim

    # ------------------------------------------------------------------
    # resets
    # ------------------------------------------------------------------

    def _sample_spawn(self, gen: torch.Generator, n: int):
        """Spawn points drawn from the terrain's table; with group_obs one
        center a group of consecutive envs plus a uniform jitter, kept two
        cells inside the map."""
        cfg = self.cfg
        dev = self.device
        table = self.terrain.spawnable_xy
        if not cfg.group_obs:
            return table[pmesh.draw_rows(torch.randint, (n,), self.mesh, 0,
                                         table.shape[0], generator=gen,
                                         device=dev)]
        # the rank's groups are its block of the groups (the shards fall on
        # group boundaries)
        G = cfg.obs_group_size
        ng = -(-n // G)
        centers = table[pmesh.draw_rows(torch.randint, (ng,), self.mesh, 0,
                                        table.shape[0], generator=gen,
                                        device=dev)]
        H, W = self.terrain.shape
        cell = self.terrain.cell
        spread = min(cfg.group_spawn_spread, 0.25 * (min(H, W) - 1) * cell)
        jit = (pmesh.draw_rows(torch.rand, (ng, G, 2), self.mesh,
                               generator=gen, device=dev)
               * (2 * spread) - spread)
        xy = (centers[:, None] + jit).reshape(ng * G, 2)[:n]
        origin = torch.tensor(self.terrain.origin, device=dev)
        lo = origin + 2 * cell
        hi = origin + torch.tensor([(H - 3) * cell, (W - 3) * cell],
                                   device=dev)
        return torch.clamp(xy, lo, hi)

    def _reset_states(self, gen: torch.Generator, n: int,
                      motion_weights=None):
        """Fresh per-env states: motion-library pose (motions drawn under
        `motion_weights`, else the library's), random heading, terrain
        spawn, new trajectory. Returns the motion ids too."""
        cfg = self.cfg
        dev = self.device
        mids = ml.sample_motions(self.motion_lib, gen, n,
                                 weights=motion_weights, mesh=self.mesh)
        t = ml.sample_time(self.motion_lib, gen, mids, mesh=self.mesh)
        ms = ml.get_motion_state(self.motion_lib, mids, t)

        spawn_xy = self._sample_spawn(gen, n)
        ground_h = height_at(self.terrain, spawn_xy)

        root_rot = ms["root_rot"]
        root_vel = ms["root_vel"]
        root_ang_vel = ms["root_ang_vel"]
        if cfg.random_heading:
            yaw = (pmesh.draw_rows(torch.rand, (n,), self.mesh,
                                   generator=gen, device=dev)
                   * (2 * math.pi) - math.pi)
            ez = torch.zeros((n, 3), device=dev)
            ez[:, 2] = 1.0
            dq = quat.from_angle_axis(yaw, ez)
            hq_inv = quat.heading_quat_inv(root_rot)
            root_rot = quat.mul(dq, quat.mul(hq_inv, root_rot))
            root_vel = quat.rotate(dq, quat.rotate(hq_inv, root_vel))
            root_ang_vel = quat.rotate(dq, quat.rotate(hq_inv, root_ang_vel))

        root_pos = torch.cat(
            [spawn_xy, (ms["root_pos"][:, 2] + ground_h)[:, None]], -1)

        # default pose with probability 1 − ref_state_init_prob
        use_ref = (pmesh.draw_rows(torch.rand, (n,), self.mesh,
                                   generator=gen, device=dev)
                   < cfg.ref_state_init_prob)
        ident = quat.identity_like((n, bm.NUM_BODIES), device=dev)
        local_rot = _select(use_ref, ms["local_rot"], ident)
        zed = torch.zeros((n, 3), device=dev)
        root_pos_d = torch.cat(
            [spawn_xy, (self.params.height_offset[:n] + ground_h)[:, None]],
            -1)
        root_pos = _select(use_ref, root_pos, root_pos_d)
        root_rot = _select(use_ref, root_rot, quat.identity_like(
            (n,), device=dev))
        root_vel = _select(use_ref, root_vel, zed)
        root_ang_vel = _select(use_ref, root_ang_vel, zed)
        dof_vel = _select(use_ref, ms["dof_vel"],
                          torch.zeros((n, bm.NUM_JOINTS, 3), device=dev))
        local_rot = torch.cat([root_rot[:, None], local_rot[:, 1:]], dim=1)

        physics = kinematic_state(
            self.model, self.tree, root_pos, root_rot, local_rot,
            root_vel=root_vel, root_ang_vel=root_ang_vel, dof_vel=dof_vel)
        verts, inverted = traj_gen.sample_traj(
            gen, cfg.traj, root_pos, root_vel=root_vel,
            real_bank=self.real_traj_bank, mesh=self.mesh)
        return physics, verts, inverted, mids.to(torch.int32)

    def _capture_locoval_inputs(self, physics: PhysicsState, verts):
        """Waypoints and initial pose/velocity for the LocoVal function,
        origin-normalized."""
        cfg = self.cfg
        times = torch.zeros((verts.shape[0],), device=self.device)
        wp = traj_gen.fetch_samples(verts, times, cfg.traj.episode_dur,
                                    cfg.num_waypoints,
                                    cfg.traj_sample_timestep)[..., :2]
        wp = wp - physics.body_x[:, 0, :2][:, None]
        pose = physics.body_x - physics.body_x[:, 0:1]
        return wp, pose, physics.body_v[:, 0, :2]

    def reset(self, generator: torch.Generator) -> EnvState:
        """Every env's first state (`_reset`). Under a mesh, this rank's
        part (parallel.mesh.shard_env_axis) of the whole env axis's reset,
        as the JAX CLI places agent.init's state (cli/run.py:126-133): a
        copy of the env over all cfg.num_envs bodies resets them, drawing
        from `generator` as the one-rank env does."""
        if self.mesh is None or self.mesh.size == 1:
            return self._reset(generator)
        whole = copy.copy(self)
        whole.mesh, whole.num_envs = None, self.cfg.num_envs
        whole._bind_params(self._all_params)
        return pmesh.shard_env_axis(whole._reset(generator), self.mesh,
                                    self.cfg.num_envs)

    def _reset(self, generator: torch.Generator) -> EnvState:
        cfg = self.cfg
        n = self.num_envs
        dev = self.device
        physics, verts, inverted, mids = self._reset_states(generator, n)
        wp, pose, vel = self._capture_locoval_inputs(physics, verts)
        amp = self._amp_obs_single(physics)
        hist = amp[:, None].repeat(1, cfg.num_amp_obs_steps, 1)
        clock0 = torch.zeros((), dtype=torch.int32, device=dev)
        scales = (self._sample_dr_scales(generator, n, clock0)
                  if cfg.dr.enabled else self._neutral_dr_scales(n))
        hn = {}
        if cfg.hard_negative:
            M = self.motion_lib.num_motions
            hn = dict(motion_weights=self.motion_lib.weights.clone(),
                      cur_mid=mids,
                      motion_sampled=torch.zeros((M,), device=dev),
                      motion_term=torch.zeros((M,), device=dev),
                      motion_succ=torch.ones((M,), device=dev))
        return EnvState(
            **hn,
            physics=physics, traj_verts=verts, inverted=inverted,
            progress=torch.zeros((n,), dtype=torch.int32, device=dev),
            reset_buf=torch.zeros((n,), dtype=torch.bool, device=dev),
            terminate_buf=torch.zeros((n,), dtype=torch.bool, device=dev),
            rng=generator, amp_obs_hist=hist, waypoint_traj=wp,
            init_pose=pose, init_vel=vel, dr_scales=scales, dr_clock=clock0,
            dr_last=torch.zeros((n,), dtype=torch.int32, device=dev))

    # ------------------------------------------------------------------
    # scheduled domain randomization
    # ------------------------------------------------------------------

    def _neutral_dr_scales(self, n):
        s = torch.ones((n, NUM_DR_PROPS), device=self.device)
        s[:, 4] = 0.0                       # rest offset is additive
        return s

    def _sample_dr_scales(self, gen, n, clock):
        """Per-env property scales, ramped linearly toward the ranges."""
        dr = self.cfg.dr
        ramp = (torch.clamp(clock.float() / dr.schedule_steps, max=1.0)
                if dr.schedule_steps > 0 else 1.0)
        ranges = torch.tensor([dr.mass_range, dr.kp_range, dr.kd_range,
                               dr.friction_range, dr.rest_offset_range],
                              device=self.device)
        u = pmesh.draw_rows(torch.rand, (n, NUM_DR_PROPS), self.mesh,
                            generator=gen, device=self.device)
        raw = ranges[:, 0] + u * (ranges[:, 1] - ranges[:, 0])
        neutral = self._neutral_dr_scales(n)
        return neutral + ramp * (raw - neutral)

    def _dr_model(self, state: EnvState):
        """The model with the env's current DR scales folded in."""
        if not self.cfg.dr.enabled:
            return self.model
        s = state.dr_scales
        p = self.model.params
        m, kp, kd, fr, ro = (s[:, 0], s[:, 1], s[:, 2], s[:, 3], s[:, 4])
        p = p.replace(
            mass=p.mass * m[:, None],
            inv_mass=p.inv_mass / m[:, None],
            inertia=p.inertia * m[:, None, None],
            inv_inertia=p.inv_inertia / m[:, None, None],
            kp=p.kp * kp[:, None],
            kd=p.kd * kd[:, None],
            friction_scale=p.friction_scale * fr,
            capsule_radius=p.capsule_radius + ro[:, None],
            mesh_point_radius=p.mesh_point_radius + ro[:, None, None],
        )
        return self.model.replace(params=p)

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------

    def _amp_obs_single(self, physics: PhysicsState):
        pos, rot, vel, ang = body_frame_state(self.model, physics)
        dof_pos, dof_vel = joint_state(self.model, physics)
        return obs.amp_obs(pos[:, 0], rot[:, 0], vel[:, 0], ang[:, 0],
                           dof_pos, dof_vel, pos[:, self._key_ids],
                           betas=self._obs_betas,
                           limb_weights=self._obs_limbw)

    def _self_obs(self, physics: PhysicsState):
        pos, rot, vel, ang = body_frame_state(self.model, physics)
        return obs.humanoid_obs_max(pos, rot, vel, ang,
                                    betas=self._obs_betas,
                                    limb_weights=self._obs_limbw)

    def _task_obs(self, state: EnvState):
        """[trajectory samples | sensor | crowd]: the sensor a height map or
        a velocity map, with the group's people stamped in under
        group_obs."""
        cfg = self.cfg
        physics = state.physics
        pos, rot, _, _ = body_frame_state(self.model, physics)
        root_pos, root_rot = pos[:, 0], rot[:, 0]
        times = state.progress.float() * cfg.dt
        samples = traj_gen.fetch_samples(
            state.traj_verts, times, cfg.traj.episode_dur,
            cfg.num_traj_samples, cfg.traj_sample_timestep)
        parts = [obs.location_obs(root_pos, root_rot, samples)]
        gsz = cfg.obs_group_size
        if cfg.terrain_obs:
            head = pos[:, self._head]
            sensor = (self.terrain, head, root_rot, root_pos[:, :2],
                      self.sensor_grid)
            vel = physics.body_v[:, 0]
            if cfg.velocity_map and cfg.group_obs:
                parts.append(obs.group_velocity_map_obs(
                    *sensor, root_pos, vel, gsz, cfg.height_meas_scale))
            elif cfg.velocity_map:
                parts.append(obs.velocity_map_obs(*sensor, vel,
                                                  cfg.height_meas_scale))
            else:
                parts.append(obs.heightmap_obs(*sensor,
                                               cfg.height_meas_scale))
        if cfg.group_obs:
            parts.append(obs.group_obs(pos, physics.body_v, root_rot, gsz))
        return torch.cat(parts, -1)

    def observe(self, state: EnvState):
        with annotate("env.observe"):
            return torch.cat([self._self_obs(state.physics),
                              self._task_obs(state)], -1)

    def observe_with_traj(self, state: EnvState, traj_samples):
        """The observation with its trajectory slice rebuilt from the
        hypothetical samples `traj_samples` (N, S, 3): differentiable with
        respect to them, so a critic's gradient reaches the trajectory."""
        o = self.observe(state)
        pos, rot, _, _ = body_frame_state(self.model, state.physics)
        loc = obs.location_obs(pos[:, 0], rot[:, 0], traj_samples)
        base = self.cfg.self_obs_dim
        S = self.cfg.num_traj_samples * 2
        return torch.cat([o[:, :base], loc, o[:, base + S:]], -1)

    def observe_flipped(self, state: EnvState):
        """Left/right mirrored observation computed from the state: the
        oracle of observe_flipped_from, which training runs."""
        pos, rot, vel, ang = body_frame_state(self.model, state.physics)
        self_obs = obs.humanoid_obs_max(*obs.flip_body_state(pos, rot, vel,
                                                             ang),
                                        betas=self._obs_betas,
                                        limb_weights=self._obs_limbw)
        return torch.cat([self_obs]
                         + self._flip_task_parts(self._task_obs(state)), -1)

    def observe_flipped_from(self, obs_full):
        """Mirror a computed observation in feature space: a static signed
        permutation of the self obs (observations.build_self_obs_flip) and a
        feature-level mirror of the task obs, with no second sensor pass."""
        sd = self.cfg.self_obs_dim
        self_obs = obs_full[:, :sd][:, self._flip_self_idx] \
            * self._flip_self_sign
        task = obs_full[:, sd:sd + self.task_obs_dim]
        return torch.cat([self_obs] + self._flip_task_parts(task), -1)

    def _flip_task_extra(self, extra):
        """Mirror of a variant's task-obs insert; the identity here."""
        return extra

    def _flip_task_parts(self, task):
        """The mirrored task obs, part by part: trajectory samples negate y;
        a variant's insert after them goes through _flip_task_extra; the
        sensor mirrors its points (the square grid reverses its minor (y)
        axis, the other shapes take the grid's flip permutation) and the
        velocity map negates its lateral channel; every (x, y, z) triplet of
        the crowd observation negates y."""
        cfg = self.cfg
        S = cfg.num_traj_samples
        n = task.shape[0]
        loc = task[:, :2 * S].reshape(n, S, 2) \
            * torch.tensor([1.0, -1.0], device=task.device)
        parts = [loc.reshape(n, 2 * S)]
        off = 2 * S
        if self._task_extra_dim:
            parts.append(self._flip_task_extra(
                task[:, off:off + self._task_extra_dim]))
            off += self._task_extra_dim
        if cfg.terrain_obs:
            P, res = cfg.num_sensor_points, cfg.sensor_res
            C = 3 if cfg.velocity_map else 1
            hm = task[:, off:off + P * C].reshape(n, P, C)
            if cfg.sensor_shape == "square":
                hm = hm.reshape(n, res, res, C).flip(2).reshape(n, P, C)
            else:
                hm = hm[:, self.sensor_flip_perm]
            if cfg.velocity_map:
                hm = hm * torch.tensor([1.0, 1.0, -1.0], device=task.device)
            parts.append(hm.reshape(n, P * C))
            off += P * C
        if cfg.group_obs:
            grp = task[:, off:].reshape(n, -1, 3) \
                * torch.tensor([1.0, -1.0, 1.0], device=task.device)
            parts.append(grp.reshape(n, -1))
        return parts

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def step(self, state: EnvState, actions: torch.Tensor):
        """actions (N, 69) in [-1, 1] exp-map scale → PD targets → one
        control step, reward, terminations, AMP history, auto-reset."""
        with annotate("env.step"):
            cfg = self.cfg
            gen = state.rng
            if cfg.action_noise_std > 0:
                actions = actions + cfg.action_noise_std * action_noise_draw(
                    gen, actions.shape, actions.device, self.mesh)
            a = actions.reshape(-1, bm.NUM_JOINTS, 3)
            pd_target = (a * self.pd_action_scale[None]
                         * self.action_mask[None])
            physics = physics_step(self._dr_model(state), self.terrain,
                                   state.physics, pd_target, cfg.engine,
                                   self.tree)
            physics = self._perturb(physics, state.progress, gen)
            progress = state.progress + 1

            with annotate("env.reward"):
                reward, reward_raw = self._reward(state, physics, progress,
                                                  pd_target)
            with annotate("env.ends"):
                times = progress.float() * cfg.dt
                tar = traj_gen.calc_pos(state.traj_verts, times,
                                        cfg.traj.episode_dur)
                root_xy = physics.body_x[:, 0, :2]

                pos, _, _, _ = body_frame_state(self.model, physics)
                contact = torch.linalg.norm(physics.contact_force, dim=-1)
                allowed = torch.zeros((bm.NUM_BODIES,), dtype=torch.bool,
                                      device=self.device)
                allowed[self._contact_ids] = True
                bad_contact = torch.any(contact * (~allowed)[None]
                                        > cfg.contact_force_threshold, -1)
                ground = height_at(self.terrain, pos[..., :2].reshape(-1, 2))
                body_h = pos[..., 2] - ground.reshape(pos.shape[0], -1)
                low = body_h < cfg.termination_height
                low[:, self._contact_ids] = False
                has_fallen = bad_contact & torch.any(low, -1) & (progress > 1)
                tar_fail = torch.sum((tar[:, :2] - root_xy) ** 2, -1) \
                    > cfg.fail_dist ** 2
                terminated = ((has_fallen | tar_fail)
                              if cfg.enable_early_termination
                              else torch.zeros_like(has_fallen))
                terminated = terminated & self._termination_allowed(state)
                # a numerically diverged env must recycle: NaN fails every
                # check
                bad = (~torch.isfinite(physics.u).all(-1)
                       | ~torch.isfinite(physics.root_pos).all(-1)
                       | ~torch.isfinite(physics.joint_rot).all(-1).all(-1)
                       | ~torch.isfinite(physics.body_x).all(-1).all(-1)
                       | (torch.abs(physics.root_pos) > 1e4).any(-1))
                terminated = terminated | bad
                done = terminated | (progress >= cfg.episode_length - 1)

            amp = self._amp_obs_single(physics)
            hist = torch.cat([amp[:, None], state.amp_obs_hist[:, :-1]],
                             dim=1)
            new_state = state.replace(physics=physics, progress=progress,
                                      reset_buf=done,
                                      terminate_buf=terminated,
                                      amp_obs_hist=hist,
                                      dr_clock=state.dr_clock + 1)
            with annotate("env.auto_reset"):
                new_state = self._auto_reset(new_state, done)
            obs_out = self.observe(new_state)
            if cfg.obs_noise_std > 0:
                obs_out = obs_out + cfg.obs_noise_std * obs_noise_draw(
                    gen, obs_out.shape, obs_out.device, self.mesh)

            def clean(x):
                return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)

            out = StepOutput(
                obs=clean(obs_out),
                reward=clean(reward),
                done=done,
                terminated=terminated,
                # the pre-reset window: the transition the policy produced
                amp_obs=clean(hist.reshape(self.num_envs, -1)),
                reward_raw=clean(reward_raw),
            )
            return new_state, out

    def _termination_allowed(self, state: EnvState):
        """(N,) bool: the envs whose early termination counts this step
        (a variant's grace period clears it); all here."""
        return torch.ones((self.num_envs,), dtype=torch.bool,
                          device=self.device)

    def _perturb(self, physics, progress, gen: torch.Generator):
        """After the physics step: root pushes on the envs whose `progress`
        (before the step) ends a push interval, then projectile hits on
        those ending a projectile interval."""
        cfg = self.cfg
        n = self.num_envs
        if cfg.push_interval > 0:
            hit = progress % cfg.push_interval == cfg.push_interval - 1
            physics = physics.replace(u=push_kick(
                physics.u, hit, push_draw(gen, n, self.device, self.mesh),
                cfg.push_vel))
        if cfg.projectile_interval > 0:
            hit = (progress % cfg.projectile_interval
                   == cfg.projectile_interval - 1)
            body, raw = projectile_draw(gen, n, self.device, self.mesh)
            physics = physics.replace(u=projectile_kick(
                physics.u, hit, body, raw, cfg.projectile_impulse,
                physics.body_x, self._mass_tot))
        return physics

    def _reward(self, state: EnvState, physics, progress, pd_target):
        """Location reward + power penalty."""
        cfg = self.cfg
        times = progress.float() * cfg.dt
        tar = traj_gen.calc_pos(state.traj_verts, times, cfg.traj.episode_dur)
        err = torch.sum((tar[:, :2] - physics.body_x[:, 0, :2]) ** 2, -1)
        loc_reward = cfg.location_coefficient * torch.exp(-2.0 * err)

        dof_pos, dof_vel = joint_state(self.model, physics)
        # the torques the sim applied: DR-scaled gains, torque-limited
        p = self._dr_model(state).params
        tau = (p.kp[..., None] * (pd_target - dof_pos)
               - p.kd[..., None] * dof_vel)
        nrm = torch.linalg.norm(tau, dim=-1, keepdim=True)
        cap = p.torque_limit[..., None]
        tau = tau * (torch.minimum(nrm, cap) / torch.clamp(nrm, min=1e-9))
        power = torch.abs(tau * dof_vel).sum((-2, -1))
        pow_reward = -cfg.power_coefficient * power
        reward = loc_reward + (pow_reward if cfg.power_reward else 0.0)
        return reward, torch.stack([loc_reward, pow_reward], -1)

    def _auto_reset(self, state: EnvState, done):
        """Fresh states for every env, selected where `done`."""
        cfg = self.cfg
        n = self.num_envs
        physics_new, verts_new, inv_new, mids_new = self._reset_states(
            state.rng, n, motion_weights=state.motion_weights)
        wp, pose, vel = self._capture_locoval_inputs(physics_new, verts_new)

        dr_scales, dr_last = state.dr_scales, state.dr_last
        if cfg.dr.enabled:
            due = done & (state.dr_clock - dr_last >= cfg.dr.frequency)
            fresh = self._sample_dr_scales(state.rng, n, state.dr_clock)
            dr_scales = _select(due, fresh, dr_scales)
            dr_last = torch.where(due, state.dr_clock, dr_last)

        # hard-negative bookkeeping: each finishing episode counts one
        # sample of its motion, an early termination one failure, summed
        # over the ranks (integer counts in float32, exact below 2^24)
        hn = {}
        if cfg.hard_negative:
            d = done.float()
            mid = state.cur_mid
            zero = torch.zeros_like(state.motion_sampled)
            new = pmesh.all_reduce_sum(torch.stack([
                zero.index_add(0, mid, d),
                zero.index_add(0, mid, d * state.terminate_buf.float())]),
                self.mesh)
            hn = dict(
                motion_sampled=state.motion_sampled + new[0],
                motion_term=state.motion_term + new[1],
                cur_mid=torch.where(done, mids_new, mid))

        physics = dataclasses.replace(physics_new, **{
            f.name: _select(done, getattr(physics_new, f.name),
                            getattr(state.physics, f.name))
            for f in dataclasses.fields(physics_new)})
        amp_new = self._amp_obs_single(physics_new)
        hist_new = amp_new[:, None].repeat(1, cfg.num_amp_obs_steps, 1)
        return state.replace(
            **hn,
            physics=physics,
            traj_verts=_select(done, verts_new, state.traj_verts),
            inverted=_select(done, inv_new, state.inverted),
            progress=torch.where(done, 0, state.progress),
            amp_obs_hist=_select(done, hist_new, state.amp_obs_hist),
            waypoint_traj=_select(done, wp, state.waypoint_traj),
            init_pose=_select(done, pose, state.init_pose),
            init_vel=_select(done, vel, state.init_vel),
            dr_scales=dr_scales,
            dr_last=dr_last,
        )

    def apply_hard_negative_update(self, state: EnvState) -> EnvState:
        """The per-epoch refresh of the live motion-sampling weights from
        the episode counts since the last one (motion_lib.
        hard_negative_update); the identity unless cfg.hard_negative."""
        if not self.cfg.hard_negative:
            return state
        w, succ, sampled, term = ml.hard_negative_update(
            state.motion_succ, state.motion_sampled, state.motion_term,
            temp=self.cfg.hard_negative_temp)
        return state.replace(motion_weights=w, motion_succ=succ,
                             motion_sampled=sampled, motion_term=term)

    # ------------------------------------------------------------------
    # AMP demo fetch
    # ------------------------------------------------------------------

    def sample_amp_demo(self, gen: torch.Generator, num_samples: int,
                        motion_weights=None):
        """The demo fetch's draws: motion ids (under `motion_weights`, else
        the library's) and each window's newest time t0, late enough that
        the whole window lies in the clip."""
        mids = ml.sample_motions(self.motion_lib, gen, num_samples,
                                 weights=motion_weights)
        truncate = self.cfg.dt * (self.cfg.num_amp_obs_steps - 1)
        t0 = ml.sample_time(self.motion_lib, gen, mids,
                            truncate_time=truncate)
        return mids, t0 + truncate

    def amp_obs_demo(self, mids, t0):
        """(num_samples, S·amp_dim) demo windows at (motion ids, t0), newest
        step first as in the live window."""
        cfg = self.cfg
        S = cfg.num_amp_obs_steps
        offsets = -torch.arange(S, device=self.device) * cfg.dt
        ts = (t0[:, None] + offsets[None]).reshape(-1)
        mids_rep = torch.repeat_interleave(mids, S)
        ms = ml.get_motion_state(self.motion_lib, mids_rep, ts)
        limbw = (self.limb_weights[:1].expand(len(mids_rep), -1)
                 if cfg.has_limb_weight_obs else None)
        a = obs.amp_obs(ms["root_pos"], ms["root_rot"], ms["root_vel"],
                        ms["root_ang_vel"], ms["dof_pos"], ms["dof_vel"],
                        ms["key_pos"],
                        betas=ms["betas"] if cfg.has_shape_obs else None,
                        limb_weights=limbw)
        return a.reshape(mids.shape[0], -1)

    def fetch_amp_obs_demo(self, gen: torch.Generator, num_samples: int,
                           motion_weights=None):
        """Demo AMP windows drawn from the motion library, the motions under
        `motion_weights` (the live hard-negative weights) where given."""
        return self.amp_obs_demo(*self.sample_amp_demo(
            gen, num_samples, motion_weights))
