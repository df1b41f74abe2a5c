"""The rollout control step at the bench configuration.

The configuration `bench.py:main` runs for the JAX package: 4,096 envs,
sensor_res 32, 15 AMP steps, episode length 168, the default engine, mixed
terrain (map_length 8, 2 tiles, difficulty 0.5) and synthetic walks at 1.0
and 1.5 m/s; the actor at its default widths with seeded random weights.
`chip_smoke.py` and `profile_step` both build it here, so the configuration
lives in one place. `Rollout.with_engine` gives the same rollout under
another engine configuration (solver branch) on the same terrain, motion
library and actor.
"""
from __future__ import annotations

import dataclasses

import torch

from . import device as _device
from .envs import EnvConfig, PedestrianTerrainEnv
from .kinematics import motion_lib as ml
from .learning import AMPSeptValueNet, RunningNorm
from .physics import EngineConfig, generate_mixed_terrain


@dataclasses.dataclass
class Rollout:
    cfg: EnvConfig
    env: PedestrianTerrainEnv
    actor: AMPSeptValueNet
    norm: RunningNorm

    def act(self, obs: torch.Tensor) -> torch.Tensor:
        """normalize → actor, the action mean."""
        with torch.no_grad():
            return self.actor.actor(self.norm.normalize(obs))[0]

    def control_step(self, state):
        """observe → normalize → actor → env.step; returns the new state,
        the step's output, the observation and the action."""
        obs = self.env.observe(state)
        mu = self.act(obs)
        state, out = self.env.step(state, mu)
        return state, out, obs, mu

    def with_engine(self, engine: EngineConfig) -> "Rollout":
        """This rollout with `engine` in place of its engine configuration:
        a new env on the same terrain and motion library, the same actor
        and norm."""
        cfg = dataclasses.replace(self.cfg, engine=engine)
        env = PedestrianTerrainEnv(cfg, self.env.terrain,
                                   self.env.motion_lib,
                                   device=self.env.device)
        return Rollout(cfg, env, self.actor, self.norm)


def build_bench(num_envs: int = 4096, device=None, seed: int = 1,
                engine: EngineConfig = EngineConfig()) -> Rollout:
    """The env, actor and observation norm at the bench configuration, with
    `engine` as the engine configuration; the actor's weights are drawn from
    a torch.Generator seeded with `seed`."""
    dev = _device.resolve(device)
    cfg = EnvConfig(num_envs=num_envs, sensor_res=32, episode_length=168,
                    num_amp_obs_steps=15, engine=engine)
    env = PedestrianTerrainEnv(
        cfg, generate_mixed_terrain(map_length=8.0, num_tiles=2,
                                    difficulty=0.5, device=dev),
        ml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                  device=dev), device=dev)
    actor = AMPSeptValueNet(
        cfg.num_actions, cfg.self_obs_dim, cfg.num_traj_samples * 2,
        cfg.task_obs_dim,
        generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    return Rollout(cfg, env, actor, RunningNorm.create(cfg.obs_dim,
                                                      device=dev))
