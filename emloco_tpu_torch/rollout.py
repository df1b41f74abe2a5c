"""The rollout control step and the training epoch at the bench's
configurations.

The configuration `bench.py:main` runs for the JAX package: 4,096 envs,
sensor_res 32, 15 AMP steps, episode length 168, the default engine, mixed
terrain (map_length 8, 2 tiles, difficulty 0.5) and synthetic walks at 1.0
and 1.5 m/s; the actor at its default widths with seeded random weights,
built for the observation of the sensor and crowd options passed as
EnvConfig fields (`SENSOR_VARIANTS` names the bench's and the reference's).
`chip_smoke.py` and `profile_step` both build it here, so the configuration
lives in one place. `Rollout.with_engine` gives the same rollout under
another engine configuration (solver branch) on the same terrain, motion
library and actor.

`build_train_bench` builds the bench's training configuration
(`bench.py:133-138`): 1,600 envs on the same env settings, terrain and
motions, and the PPO + AMP agent with `horizon=32, num_minibatches=20,
mini_epochs=6, amp_batch_size=512`, every other AMPConfig field at its
default.

`build_crowd_bench` builds the crowd training configuration on that world:
the training configuration with the reference's crowd observation
(group_obs, the 5 nearest people through the pointnet, the velocity map
with them stamped in) in groups of 100 (the largest divisor of 1,600 not
above the reference's 128) and the conv encoder over the 32×32×3 sensor
image (`network="sept_cnn"`).

`build_value_bench` builds the LocoVal training configuration on that
world: `cmd_train_valuenet` (`emloco_tpu/cli/run.py:176-223`) with the
training configuration's env, the synthetic real-trajectory bank, half of
the real paths heading-inverted, the frozen PPO + AMP agent, ValuePoseNet
with pose and velocity at 13 waypoints and ValueTrainConfig's defaults.
"""
from __future__ import annotations

import dataclasses

import torch

from . import device as _device
from .envs import EnvConfig, PedestrianTerrainEnv, traj_gen
from .kinematics import motion_lib as ml
from .learning import AMPSeptValueNet, RunningNorm, ValuePoseNet
from .learning.amp_agent import AMPAgent, AMPConfig, TrainState, build_net
from .learning.value_train import (LocoValTrainer, ValueTrainConfig,
                                   ValueTrainState)
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


TRAIN_AMP = AMPConfig(horizon=32, num_minibatches=20, mini_epochs=6,
                      amp_batch_size=512)
# the crowd training configuration's changes to TRAIN_AMP and the env
CROWD_AMP = dict(network="sept_cnn")
CROWD_ENV = dict(group_obs=True, group_size=100, velocity_map=True)
# sensor variants of the control step: the bench's velocity map
# (bench.py:123-124), the reference's group size with the people stamped
# into the velocity map, and the forward fan of 450 points
SENSOR_VARIANTS = (
    ("velocity_map", dict(velocity_map=True)),
    ("group_velocity_map", dict(group_obs=True, group_size=128,
                                velocity_map=True)),
    ("fov", dict(sensor_shape="fov")),
)


def parse_overrides(items):
    """["amp.horizon=4", "env.sensor_res=8"] → ({"horizon": 4},
    {"sensor_res": 8}), each value typed as its field's default; the
    entry points' `amp.<field>=<value>` and `env.<field>=<value>`
    arguments."""
    out = {"amp": {}, "env": {}}
    defaults = {"amp": TRAIN_AMP, "env": EnvConfig()}
    for item in items:
        key, sep, value = item.partition("=")
        part, _, name = key.partition(".")
        if not sep or part not in out or not hasattr(defaults[part], name):
            raise SystemExit(f"bad override {item!r}: expected "
                             "amp.<field>=<value> or env.<field>=<value>")
        kind = type(getattr(defaults[part], name))
        if kind is bool:
            out[part][name] = value.lower() in ("1", "true", "yes")
        else:
            out[part][name] = kind(value)
    return out["amp"], out["env"]


def _bench_env(cfg: EnvConfig, dev,
               real_traj_bank=None) -> PedestrianTerrainEnv:
    return PedestrianTerrainEnv(
        cfg, generate_mixed_terrain(map_length=8.0, num_tiles=2,
                                    difficulty=0.5, device=dev),
        ml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                  device=dev),
        real_traj_bank=real_traj_bank, device=dev)


def _bench_cfg(num_envs: int, **fields) -> EnvConfig:
    return dataclasses.replace(
        EnvConfig(num_envs=num_envs, sensor_res=32, episode_length=168,
                  num_amp_obs_steps=15), **fields)


def build_bench(num_envs: int = 4096, device=None, seed: int = 1,
                engine: EngineConfig = EngineConfig(),
                **env_fields) -> Rollout:
    """The env, actor and observation norm at the bench configuration, with
    `engine` as the engine configuration and `env_fields` (EnvConfig
    fields) replacing parts of it; the actor (with the people pointnet
    under group_obs) draws its weights from a torch.Generator seeded with
    `seed`."""
    dev = _device.resolve(device)
    cfg = _bench_cfg(num_envs, engine=engine, **env_fields)
    env = _bench_env(cfg, dev)
    actor = build_net(
        cfg, cfg.task_obs_dim, cfg.num_amp_obs_steps * cfg.amp_obs_per_step,
        generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    return Rollout(cfg, env, actor, RunningNorm.create(cfg.obs_dim,
                                                      device=dev))


def build_train_bench(num_envs: int = 1600, device=None, seed: int = 0,
                      amp: AMPConfig = TRAIN_AMP,
                      **env_fields) -> tuple[AMPAgent, TrainState]:
    """The agent at the bench's training configuration and its initial
    TrainState from `seed`; `amp` and `env_fields` (EnvConfig fields)
    replace parts of the configuration."""
    dev = _device.resolve(device)
    agent = AMPAgent(_bench_env(_bench_cfg(num_envs, **env_fields), dev),
                     amp)
    return agent, agent.init(seed)


def build_crowd_bench(num_envs: int = 1600, device=None, seed: int = 0
                      ) -> tuple[AMPAgent, TrainState]:
    """The agent at the crowd training configuration (CROWD_AMP, CROWD_ENV
    on the bench's training configuration) and its initial TrainState."""
    return build_train_bench(num_envs, device, seed,
                             dataclasses.replace(TRAIN_AMP, **CROWD_AMP),
                             **CROWD_ENV)


def build_value_bench(num_envs: int = 1600, device=None, seed: int = 0,
                      amp: AMPConfig = TRAIN_AMP,
                      env_fields: dict | None = None, **vnet_fields
                      ) -> tuple[LocoValTrainer, ValueTrainState]:
    """The LocoVal trainer at the bench's training configuration and its
    initial ValueTrainState: the agent from `seed` (frozen), the valuenet
    and the fresh episodes from `seed + 1`, as `cmd_train_valuenet` seeds
    them; the valuenet at ValuePoseNet's defaults (pose and velocity, 13
    waypoints). `amp`, `env_fields` (EnvConfig fields) and `vnet_fields`
    (ValuePoseNet arguments) replace parts of the configuration."""
    dev = _device.resolve(device)
    vcfg = ValueTrainConfig()
    env_cfg = _bench_cfg(num_envs, **(env_fields or {}))
    traj = dataclasses.replace(
        env_cfg.traj, heading_inversion_prob=vcfg.heading_inversion_prob)
    env_cfg = dataclasses.replace(env_cfg, traj=traj)
    agent = AMPAgent(_bench_env(env_cfg, dev,
                                traj_gen.synthetic_real_bank(device=dev)),
                     amp)
    ts = agent.init(seed)
    vnet = ValuePoseNet(**vnet_fields, device=dev)
    trainer = LocoValTrainer(agent, vnet, vcfg)
    return trainer, trainer.init(ts, seed + 1)
