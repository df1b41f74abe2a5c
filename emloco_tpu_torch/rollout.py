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

`build_getup_bench` and `build_hand_bench` build the training configuration
of the getup and the hand task (`--task getup|hand` of `cli/run.py`): the
task's env class (`TASK_ENVS`) on the same world, the getup one with its
engine (`TASK_ENGINES`: self-contact and mesh colliders). Wherever a
training configuration's engine runs mesh contacts, the colliders are fit
to the SMPL fixture (`tests/data/smpl_fixture.npz`) at betas N(0, 0.3²)
drawn from the seed, as `cli/run.py:63-80` builds them (`smpl_params`);
`build_bench`, as `bench.py`, keeps the template bodies and their
capsule-axis spheres.

`build_value_bench` builds the LocoVal training configuration on that
world: `cmd_train_valuenet` (`emloco_tpu/cli/run.py:176-223`) with the
training configuration's env, the synthetic real-trajectory bank, half of
the real paths heading-inverted, the frozen PPO + AMP agent, ValuePoseNet
with pose and velocity at 13 waypoints and ValueTrainConfig's defaults.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import device as _device
from .envs import EnvConfig, PedestrianTerrainEnv, traj_gen
from .envs.getup import GetupEnvConfig, PedestrianTerrainGetupEnv
from .envs.hand_task import PedestrianTerrainHandEnv
from .kinematics import body_model as bm
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

    def with_engine(self, engine: EngineConfig,
                    params: bm.BodyParams | None = None) -> "Rollout":
        """This rollout with `engine` in place of its engine configuration
        (and `params` in place of the bodies, where given): a new env on the
        same terrain and motion library, the same actor and norm."""
        cfg = dataclasses.replace(self.cfg, engine=engine)
        env = PedestrianTerrainEnv(cfg, self.env.terrain,
                                   self.env.motion_lib, params=params,
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


# the tasks of `cli/run.py`: each one's env class, config class and engine
TASKS = ("terrain", "getup", "hand")
TASK_ENVS = {"terrain": PedestrianTerrainEnv,
             "getup": PedestrianTerrainGetupEnv,
             "hand": PedestrianTerrainHandEnv}
TASK_CONFIGS = {"terrain": EnvConfig, "getup": GetupEnvConfig,
                "hand": EnvConfig}
TASK_ENGINES = {"terrain": EngineConfig(), "hand": EngineConfig(),
                "getup": EngineConfig(self_contact=True, mesh_contacts=True)}
SMPL_FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests",
    "data", "smpl_fixture.npz")


def parse_overrides(items, task: str = "terrain"):
    """["amp.horizon=4", "env.sensor_res=8", "engine.self_contact=true"] →
    ({"horizon": 4}, {"sensor_res": 8, "engine": EngineConfig(...)}), each
    value typed as its field's default; the entry points'
    `amp.<field>=<value>`, `env.<field>=<value>` (fields of the task's env
    config) and `engine.<field>=<value>` arguments, the last applied to
    the task's engine and returned as env["engine"]."""
    out = {"amp": {}, "env": {}, "engine": {}}
    defaults = {"amp": TRAIN_AMP, "env": TASK_CONFIGS[task](),
                "engine": TASK_ENGINES[task]}
    for item in items:
        key, sep, value = item.partition("=")
        part, _, name = key.partition(".")
        if (not sep or part not in out or name == "engine"
                or not hasattr(defaults[part], name)):
            raise SystemExit(f"bad override {item!r}: expected "
                             "amp.<field>=<value>, env.<field>=<value> or "
                             "engine.<field>=<value>")
        kind = type(getattr(defaults[part], name))
        if kind is bool:
            out[part][name] = value.lower() in ("1", "true", "yes")
        else:
            out[part][name] = kind(value)
    if out["engine"]:
        out["env"]["engine"] = dataclasses.replace(defaults["engine"],
                                                   **out["engine"])
    return out["amp"], out["env"]


def smpl_params(num_envs: int, device=None, seed: int = 0) -> bm.BodyParams:
    """Bodies with mesh colliders fit to the SMPL fixture at betas
    N(0, 0.3²) (num_envs, 16) from a numpy generator seeded with `seed`."""
    betas = np.random.RandomState(seed).randn(num_envs, 16) * 0.3
    return bm.from_smpl_npz(SMPL_FIXTURE, betas.astype(np.float32),
                            device=device)


def _bench_env(cfg: EnvConfig, dev, real_traj_bank=None,
               task: str = "terrain", params=None) -> PedestrianTerrainEnv:
    """The task's env on the bench's terrain and motions."""
    return TASK_ENVS[task](
        cfg, generate_mixed_terrain(map_length=8.0, num_tiles=2,
                                    difficulty=0.5, device=dev),
        ml.synthetic_walk_motions(speeds=(1.0, 1.5), duration=2.0,
                                  device=dev),
        real_traj_bank=real_traj_bank, params=params, device=dev)


def _bench_cfg(num_envs: int, task: str = "terrain", **fields) -> EnvConfig:
    base = dict(num_envs=num_envs, sensor_res=32, episode_length=168,
                num_amp_obs_steps=15, engine=TASK_ENGINES[task])
    return TASK_CONFIGS[task](**{**base, **fields})


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
                      amp: AMPConfig = TRAIN_AMP, task: str = "terrain",
                      **env_fields) -> tuple[AMPAgent, TrainState]:
    """The agent of `task` at the bench's training configuration and its
    initial TrainState from `seed`; `amp` and `env_fields` (fields of the
    task's env config, the engine TASK_ENGINES[task] unless given) replace
    parts of the configuration. With mesh contacts the bodies are
    smpl_params(num_envs, seed=seed), as `cli/run.py` fits them."""
    dev = _device.resolve(device)
    cfg = _bench_cfg(num_envs, task, **env_fields)
    params = (smpl_params(num_envs, dev, seed) if cfg.engine.mesh_contacts
              else None)
    agent = AMPAgent(_bench_env(cfg, dev, task=task, params=params), amp)
    return agent, agent.init(seed)


def build_getup_bench(num_envs: int = 1600, device=None, seed: int = 0
                      ) -> tuple[AMPAgent, TrainState]:
    """The agent at the getup training configuration: the getup env with
    self-contact and SMPL-fixture mesh colliders, TRAIN_AMP."""
    return build_train_bench(num_envs, device, seed, task="getup")


def build_hand_bench(num_envs: int = 1600, device=None, seed: int = 0
                     ) -> tuple[AMPAgent, TrainState]:
    """The agent at the hand task's training configuration."""
    return build_train_bench(num_envs, device, seed, task="hand")


def build_crowd_bench(num_envs: int = 1600, device=None, seed: int = 0
                      ) -> tuple[AMPAgent, TrainState]:
    """The agent at the crowd training configuration (CROWD_AMP, CROWD_ENV
    on the bench's training configuration) and its initial TrainState."""
    return build_train_bench(num_envs, device, seed,
                             dataclasses.replace(TRAIN_AMP, **CROWD_AMP),
                             **CROWD_ENV)


def build_value_bench(num_envs: int = 1600, device=None, seed: int = 0,
                      amp: AMPConfig = TRAIN_AMP,
                      env_fields: dict | None = None,
                      hard_negatives: bool = True, **vnet_fields
                      ) -> tuple[LocoValTrainer, ValueTrainState]:
    """The LocoVal trainer at the bench's training configuration and its
    initial ValueTrainState: the agent from `seed` (frozen), the valuenet
    and the fresh episodes from `seed + 1`, as `cmd_train_valuenet` seeds
    them; the valuenet at ValuePoseNet's defaults (pose and velocity, 13
    waypoints). `amp`, `env_fields` (EnvConfig fields) and `vnet_fields`
    (ValuePoseNet arguments) replace parts of the configuration. With
    `hard_negatives` (training) the real paths are heading-inverted with
    ValueTrainConfig's probability; without (`cmd_eval_policy`) the env's
    trajectory configuration stays as it is."""
    dev = _device.resolve(device)
    vcfg = ValueTrainConfig()
    env_cfg = _bench_cfg(num_envs, **(env_fields or {}))
    if hard_negatives:
        env_cfg = dataclasses.replace(env_cfg, traj=dataclasses.replace(
            env_cfg.traj,
            heading_inversion_prob=vcfg.heading_inversion_prob))
    agent = AMPAgent(_bench_env(env_cfg, dev,
                                traj_gen.synthetic_real_bank(device=dev)),
                     amp)
    ts = agent.init(seed)
    vnet = ValuePoseNet(**vnet_fields, device=dev)
    trainer = LocoValTrainer(agent, vnet, vcfg)
    return trainer, trainer.init(ts, seed + 1)
