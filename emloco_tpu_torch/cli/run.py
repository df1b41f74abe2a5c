"""The system's entry point (port of emloco_tpu/cli/run.py): ten commands
over the YAML configs, on the CUDA card unless `--device cpu` is given.

    python3 -m emloco_tpu_torch.cli.run train-policy   [--config c.yaml] [k=v ...]
    python3 -m emloco_tpu_torch.cli.run train-valuenet [--policy ckpt] [...]
    python3 -m emloco_tpu_torch.cli.run eval-policy    [--policy ckpt] [--grid] [...]
    python3 -m emloco_tpu_torch.cli.run train-predictor [--valuenet ckpt] [...]
    python3 -m emloco_tpu_torch.cli.run eval-predictor --predictor ckpt [...]
    python3 -m emloco_tpu_torch.cli.run optimize-traj  --valuenet ckpt [...]
    python3 -m emloco_tpu_torch.cli.run tune-predictor [--trials N] [...]
    python3 -m emloco_tpu_torch.cli.run visualize-pred --vis-dicts a.pkl ...
    python3 -m emloco_tpu_torch.cli.run train-eqmotion [--arch full] [...]
    python3 -m emloco_tpu_torch.cli.run serve-viewer   [--policy ckpt] [--port N]

The configuration is `utils.config.load_config(--config, overrides)`:
dotted `key.subkey=value` overrides anywhere on the line. The world comes
from it (`_build_world`): the terrain of `terrain:` (`mixed`, `flat` or
`mesh`), the motions of `motions:` (the reference's motion pickle) or the
synthetic walks, the real-path bank of `real_traj_pkl:` or the synthetic
one, bodies from betas N(0, 0.3²) drawn from `seed` (fit to `smpl_npz:`, or
to the SMPL fixture under mesh contacts), and the env of `task:`. Each
command then runs the loop of the port's tool of the same name (`train`,
`train_value`, `eval_policy`, `train_predictor`, `eval_predictor`,
`optimize_traj`, `tune_predictor`, `visualize_pred`, `train_eqmotion`),
writing into `out_dir`; the training commands also write the JAX CLI's
`<name>.metrics.jsonl` and `tb/` event files (`utils.logging`).
`train-policy --profile` runs one epoch, then one more inside a
`torch.profiler` trace written to `<out_dir>/trace`, whose Chrome trace
shows the program's spans as `emloco:` ranges (`utils.profiling.annotate`:
`trainer.*`, `policy.*`, `env.*`, `physics.*`) above the operations they
launched.

`--mesh N` (N > 1) runs `train-policy` over N ranks of the env axis and
`train-predictor` over N ranks of the batch axis (parallel/mesh.py), as
the JAX CLI shards them (cli/run.py:126-133, :326-332): N processes, rank r
on `cuda:(r mod cards)` (on the CPU with `--device cpu`), joined by NCCL
when every rank has a card of its own and by gloo (over the CUDA tensors,
which stay on the card) when the ranks outnumber the cards. Each rank
prints a JSON line with its backend and the rank-to-device map first and
one with its kernels' launch counts last; rank 0 writes the checkpoints
and logs (whose rows name the backend and the map) while the others wait.
A failing rank stops the others and the command exits non-zero. Every
other command, and `--profile`, refuses `--mesh`.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import device as _device
from ..parallel import mesh as pmesh

# the commands that run over a mesh of N ranks, and the axis each splits
MESH_AXES = {"train-policy": "env", "train-predictor": "batch"}


def draw_betas(num_envs: int, seed: int) -> np.ndarray:
    """Body shapes N(0, 0.3²) (num_envs, 16) from a CPU torch.Generator
    seeded with `seed`: the same on every device."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((num_envs, 16), generator=gen) * 0.3).numpy()


def load_real_traj_bank(path: str, device) -> torch.Tensor:
    """A real-path bank (P, V, 2) float32 from a pickle: the reference's
    dict of per-scene arrays (stacked, xy kept) or the bank export's dict
    (`prediction.export.export_traj_bank`)."""
    from ..prediction.export import load_traj_bank
    return torch.as_tensor(load_traj_bank(path)[0], dtype=torch.float32,
                           device=device)


def _build_world(cfg, device=None, betas=None, mesh=None):
    """The env of `cfg` (cli/run.py:36-91) on `device`; `betas` (N, 16) in
    place of draw_betas(N, cfg.seed) where given; under an env-axis `mesh`
    this rank's block of the envs."""
    from ..envs import PedestrianTerrainEnv, traj_gen
    from ..envs.getup import PedestrianTerrainGetupEnv
    from ..envs.hand_task import PedestrianTerrainHandEnv
    from ..kinematics import body_model as bm
    from ..kinematics import motion_lib as ml
    from ..physics import (flat_terrain, generate_mixed_terrain,
                           mesh_terrain_from_file)
    from ..rollout import SMPL_FIXTURE

    dev = _device.resolve(device)
    tcfg = dict(cfg.terrain)
    ttype = tcfg.pop("type", "mixed")
    if ttype == "flat":
        terrain = flat_terrain(**tcfg, device=dev)
    elif ttype == "mesh":
        terrain = mesh_terrain_from_file(tcfg.pop("mesh_path"), **tcfg,
                                         device=dev)
    else:
        terrain = generate_mixed_terrain(**tcfg, device=dev)
    # the motion library and the bank are built on the host and copied to
    # the device (by the env), so every device holds the same bits
    cpu = torch.device("cpu")
    if cfg.motions:
        lib = ml.load_reference_pkl(cfg.motions, device=cpu)
    else:
        lib = ml.synthetic_walk_motions(device=cpu)
    if cfg.real_traj_pkl:
        bank = load_real_traj_bank(cfg.real_traj_pkl, cpu)
    else:
        bank = traj_gen.synthetic_real_bank(device=cpu)
    if betas is None:
        betas = draw_betas(cfg.env.num_envs, cfg.seed)
    betas = np.array(betas, np.float32)
    npz = cfg.smpl_npz
    if npz is None and cfg.env.engine.mesh_contacts:
        npz = SMPL_FIXTURE if os.path.exists(SMPL_FIXTURE) else None
    if npz:
        params = bm.from_smpl_npz(npz, betas, device=dev)
    else:
        params = bm.build_body_params(betas, device=dev)
    env_cls = {"getup": PedestrianTerrainGetupEnv,
               "hand": PedestrianTerrainHandEnv}.get(cfg.task,
                                                     PedestrianTerrainEnv)
    return env_cls(cfg.env, terrain, lib, real_traj_bank=bank,
                   params=params, device=dev, mesh=mesh)


def _agent(cfg, dev, policy=None, mesh=None):
    """(agent, TrainState from cfg.seed) on the world of `cfg`, with the
    params and obs / AMP norms of the policy file `policy` where given."""
    from ..learning.amp_agent import AMPAgent
    from ..utils.checkpoint import load_pytree, restore_policy
    agent = AMPAgent(_build_world(cfg, dev, mesh=mesh), cfg.amp)
    ts = agent.init(cfg.seed)
    if policy:
        ts = restore_policy(ts, load_pytree(policy)[0], full=False)
    return agent, ts


def _mesh_fields(mesh):
    """The metrics rows' record of the mesh: its backend and the device of
    each rank."""
    if mesh is None:
        return {}
    return {"mesh_backend": torch.distributed.get_backend(mesh.group),
            "mesh_devices": " ".join(mesh.devices)}


def cmd_train_policy(cfg, args, dev, mesh=None):
    from ..train import run_epochs
    from ..utils.checkpoint import (checkpoint_epoch, load_pytree,
                                    restore_policy)
    from ..utils.logging import MetricsLogger, print_json

    agent, ts = _agent(cfg, dev, mesh=mesh)
    main_rank = mesh is None or mesh.rank == 0
    start_ep = 0
    if args.resume:
        tree, meta = load_pytree(args.resume)
        ts = restore_policy(ts, tree)
        start_ep = checkpoint_epoch(args.resume, meta) + 1
        ts = ts.replace(epoch=start_ep)
    logger = MetricsLogger(cfg.out_dir, "policy") if main_rank else None
    if args.profile:
        from ..utils.profiling import trace
        ts, _ = agent.train_epoch(ts)              # warm-up, not traced
        with trace(os.path.join(cfg.out_dir, "trace")) as d:
            ts, _ = agent.train_epoch(ts)
        print(f"profile trace written to {d}", flush=True)
    steps_per_epoch = cfg.amp.horizon * cfg.env.num_envs
    t0 = time.perf_counter()

    def log(ep, ts, metrics, dt):
        if mesh is not None:
            print_json({"rank": mesh.rank, "epoch": ep, "seconds": dt})
        if ep % 10 == 0 and main_rank:
            metrics = dict(metrics, step_fps=steps_per_epoch * (
                ep - start_ep + 1) / (time.perf_counter() - t0),
                           **_mesh_fields(mesh))
            logger.log(ep, metrics)

    ts = run_epochs(agent, ts, start_ep, cfg.epochs, log, cfg.out_dir,
                    cfg.save_every)
    if main_rank:
        logger.close()
    return ts


def cmd_train_valuenet(cfg, args, dev):
    from ..learning.networks import ValuePoseNet
    from ..learning.value_train import LocoValTrainer
    from ..train_value import run_epochs
    from ..utils.checkpoint import checkpoint_epoch, load_valuenet
    from ..utils.logging import MetricsLogger

    # valuenet training inverts a share of the real paths (hard negatives)
    traj = dataclasses.replace(
        cfg.env.traj, heading_inversion_prob=cfg.value.heading_inversion_prob)
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env,
                                                           traj=traj))
    agent, ts = _agent(cfg, dev, args.policy)
    use = dict(use_pose=not args.nopose, use_vel=not args.novel)
    vnet = ValuePoseNet(**use, num_waypoints=5 if args.vru else 13,
                        device=dev)
    trainer = LocoValTrainer(agent, vnet, cfg.value)
    vts = trainer.init(ts, cfg.seed + 1)
    start = 0
    if args.resume:
        vts = vts.replace(vnet_params=load_valuenet(args.resume, dev))
        start = checkpoint_epoch(args.resume) + 1
        vts = vts.replace(epoch=start)
    logger = MetricsLogger(cfg.out_dir, "valuenet")

    def log(ep, vts, metrics, dt):
        if ep % 10 == 0:
            logger.log(ep, metrics)

    vts = run_epochs(trainer, vts, start, cfg.epochs, use, cfg.out_dir,
                     cfg.save_every, log)
    logger.close()
    return vts


def cmd_eval_policy(cfg, args, dev):
    from ..eval_policy import GRID, evaluate
    from ..learning.networks import ValuePoseNet
    from ..learning.value_train import LocoValTrainer
    from ..utils.checkpoint import load_valuenet

    if args.plots:
        import matplotlib  # noqa: F401  (fail before the rollouts)
    vnet_params = load_valuenet(args.valuenet, dev) if args.valuenet else None
    results = []
    for name, overrides in (GRID if args.grid else (("default", {}),)):
        c = cfg
        if overrides:
            traj = dataclasses.replace(cfg.env.traj, **overrides)
            c = dataclasses.replace(cfg, env=dataclasses.replace(cfg.env,
                                                                 traj=traj))
        agent, ts = _agent(c, dev, args.policy)
        vnet = ValuePoseNet(use_pose=not args.nopose, use_vel=not args.novel,
                            device=dev)
        trainer = LocoValTrainer(agent, vnet, c.value)
        vts = trainer.init(ts, c.seed + 1)
        if vnet_params is not None:
            vts = vts.replace(vnet_params=vnet_params)
        vts, line = evaluate(trainer, vts, name, overrides, args.games,
                             cfg.out_dir if args.plots else None)
        results.append(line)
        del trainer, vts, agent, ts
    return results


def _pred_dataset(cfg, seed_offset=0):
    """The predictor's scenes (cli/run.py:286-294): the ndjson windows of
    `ndjson` (`ndjson_val` for the evaluation's, where given), else
    synthetic scenes of 4 people, from cfg.seed + seed_offset."""
    from ..prediction.data import NdjsonScenes, SyntheticScenes

    path = cfg.ndjson_val if (seed_offset and cfg.ndjson_val) else cfg.ndjson
    if path:
        return NdjsonScenes(path, seed=cfg.seed + seed_offset)
    return SyntheticScenes(num_people=4, seed=cfg.seed + seed_offset)


def _tool_args(cfg, args, **kw):
    """The namespace a tool's `run` reads: this command line's flags, the
    configuration's seed, epochs and out_dir, and `kw`."""
    return argparse.Namespace(**{**vars(args), "seed": cfg.seed,
                                 "epochs": cfg.epochs, "out": cfg.out_dir,
                                 **kw})


def cmd_train_predictor(cfg, args, dev, mesh=None):
    from .. import train_predictor
    from ..utils.logging import MetricsLogger

    ts, history, best = train_predictor.run(
        _tool_args(cfg, args), cfg.model, cfg.predict, _pred_dataset(cfg),
        _pred_dataset(cfg, seed_offset=1), dev, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        logger = MetricsLogger(cfg.out_dir, "predictor")
        for h in history:
            h = dict(h, **_mesh_fields(mesh))
            logger.log(h.pop("epoch"), h)
        logger.close()
    return ts, history, best


def cmd_eval_predictor(cfg, args, dev):
    from .. import eval_predictor

    if not args.predictor:
        raise SystemExit("eval-predictor needs --predictor")
    if args.plots:
        if not args.valuenet:
            raise SystemExit("eval-predictor --plots needs --valuenet (the "
                             "plots show values)")
        import matplotlib  # noqa: F401  (fail before the evaluation)
    return eval_predictor.run(_tool_args(cfg, args), cfg.model, cfg.predict,
                              _pred_dataset(cfg, seed_offset=2), dev)


def cmd_tune_predictor(cfg, args, dev):
    from .. import tune_predictor

    return tune_predictor.run(
        _tool_args(cfg, args, epochs=max(1, cfg.epochs)), cfg.model,
        cfg.predict, _pred_dataset(cfg), _pred_dataset(cfg, seed_offset=1),
        dev)


def cmd_visualize_pred(cfg, args, dev):
    from .. import visualize_pred

    if not args.vis_dicts:
        raise SystemExit("visualize-pred needs --vis-dicts")
    return visualize_pred.run(args.vis_dicts, args.games, cfg.out_dir)


def cmd_optimize_traj(cfg, args, dev):
    from .. import optimize_traj

    if not args.valuenet:
        raise SystemExit("optimize-traj needs --valuenet")
    return optimize_traj.run(_tool_args(cfg, args), dev)


def cmd_train_eqmotion(cfg, args, dev):
    from .. import train_eqmotion
    from ..utils.logging import MetricsLogger

    logger = MetricsLogger(cfg.out_dir, "eqmotion")
    out = train_eqmotion.run(
        _tool_args(cfg, args, ethucy=cfg.ethucy, ethucy_val=cfg.ethucy_val),
        cfg.eqmotion, dev, on_epoch=logger.log)
    logger.close()
    return out


def cmd_serve_viewer(cfg, args, dev):
    """The live viewer over HTTP (reference viewer loop + server mode,
    base_task.py:135-211, 351-430): pause / reset / push / follow /
    env-switch as POST /control commands, frames at GET /frame.png."""
    from ..envs.viewer_server import ViewerServer, ViewerSession

    agent, ts = _agent(cfg, dev, args.policy)
    session = ViewerSession(agent, ts)
    server = ViewerServer(session, port=args.port, fps=args.fps).start()
    print(f"viewer at http://127.0.0.1:{server.port}/ (ctrl-c to stop)",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


HANDLERS = {
    "train-policy": cmd_train_policy,
    "train-valuenet": cmd_train_valuenet,
    "eval-policy": cmd_eval_policy,
    "train-predictor": cmd_train_predictor,
    "eval-predictor": cmd_eval_predictor,
    "optimize-traj": cmd_optimize_traj,
    "tune-predictor": cmd_tune_predictor,
    "visualize-pred": cmd_visualize_pred,
    "train-eqmotion": cmd_train_eqmotion,
    "serve-viewer": cmd_serve_viewer,
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="emloco_tpu_torch")
    p.add_argument("command", choices=list(HANDLERS))
    p.add_argument("--config", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    p.add_argument("--policy", default=None)
    p.add_argument("--valuenet", default=None)
    p.add_argument("--predictor", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--nopose", action="store_true")
    p.add_argument("--novel", action="store_true")
    p.add_argument("--vru", action="store_true")
    p.add_argument("--games", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--batches", type=int, default=20)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--grid", action="store_true")
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--vis-dicts", nargs="*", default=[])
    p.add_argument("--gif", action="store_true")
    p.add_argument("--mesh", type=int, default=1,
                   help="train-policy, train-predictor: data parallelism "
                        "over N ranks, rank r on cuda:(r mod cards)")
    p.add_argument("--profile", action="store_true",
                   help="train-policy: write a one-epoch torch.profiler "
                        "trace")
    p.add_argument("--all-frames", action="store_true",
                   help="eval-predictor: sweep observed-frame counts 1..9")
    p.add_argument("--valueloss-w", type=float, default=0.1,
                   help="train-eqmotion: EmLoco value-loss weight")
    p.add_argument("--value-loss-mode", choices=["all", "wta"],
                   default="all",
                   help="train-eqmotion: the value loss on all modes or the "
                        "winning one")
    p.add_argument("--arch", choices=["compact", "full"], default="compact",
                   help="train-eqmotion: compact or architecture-exact")
    p.add_argument("--channels", type=int, default=64,
                   help="train-eqmotion --arch full: equivariant channels")
    p.add_argument("--apply-decay", action="store_true",
                   help="train-eqmotion: the rate x0.8 every 2 epochs")
    p.add_argument("--threshold", type=float, default=0.7,
                   help="eval-predictor, train-eqmotion: LocoVal filter "
                        "threshold")
    p.add_argument("--sweep-thresholds", action="store_true",
                   help="eval-predictor: the filter-threshold sweep")
    p.add_argument("--plots", action="store_true",
                   help="eval-predictor, eval-policy: plots (matplotlib)")
    p.add_argument("--port", type=int, default=8703,
                   help="serve-viewer: HTTP port (0 = ephemeral)")
    p.add_argument("--fps", type=float, default=10.0,
                   help="serve-viewer: sim-chunk pacing")
    p.add_argument("overrides", nargs="*",
                   help="dotted config overrides, e.g. env.num_envs=1024")
    return p


def _parse(argv):
    p = parser()
    # argparse stops collecting positionals once an optional appears between
    # them; accept key=value overrides anywhere on the line
    args, unknown = p.parse_known_args(argv)
    args.overrides = list(args.overrides) + unknown
    bad = [u for u in args.overrides if "=" not in u or u.startswith("-")]
    if bad:
        p.error(f"unrecognized arguments: {' '.join(bad)}")
    return args


def params_digest(params: dict) -> str:
    """sha256 of a parameter dict's names and bytes on the host, in name
    order: equal digests are bit-equal parameters."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_device(rank: int, device=None) -> torch.device:
    """Rank `rank`'s device: the CPU where `device` asks for it, else
    `cuda:(rank mod cards)`."""
    dev = _device.resolve(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, world: int, argv, init_url: str, threads: int):
    """One rank of `launch`: joins the group, then `run_rank(argv)`."""
    torch.set_num_threads(threads)
    dev = rank_device(rank, _parse(argv).device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pmesh.distributed_init(init_url, world, rank,
                           pmesh.backend_for(world, dev))
    try:
        run_rank(argv)
    finally:
        torch.distributed.destroy_process_group()


def run_rank(argv):
    """The command of `argv` on this process's rank of the initialized
    default group: prints the rank's backend and device map first and its
    launch counts and parameter digest last."""
    from ..physics import linalg
    from ..utils.config import load_config
    from ..utils.logging import print_json

    rank, world = torch.distributed.get_rank(), \
        torch.distributed.get_world_size()
    args = _parse(argv)
    dev = rank_device(rank, args.device)
    devices = tuple(str(rank_device(r, args.device)) for r in range(world))
    mesh = dataclasses.replace(
        pmesh.make_mesh(world, MESH_AXES[args.command], dev),
        devices=devices)
    print_json({"rank": rank, "world": world,
                "backend": torch.distributed.get_backend(),
                "device": str(dev), "devices": list(devices)})
    cfg = load_config(args.config, args.overrides)
    _device.full_float32(dev)
    res = HANDLERS[args.command](cfg, args, dev, mesh=mesh)
    # train-policy's final parameters; train-predictor's best, which its
    # checkpoint holds
    params = res.params if args.command == "train-policy" else res[2]
    print_json({"rank": rank, "launches": dict(linalg.LAUNCHES),
                "params_sha256": params_digest(params)})


def launch(world: int, argv, threads: int | None = None, target=None):
    """Runs `target(rank, world, argv, init_url, threads)` (the command of
    `argv`: `_rank_main`) on `world` ranks, each a spawned process, joined
    through a file store in a temporary directory. When a rank fails the
    others are stopped and SystemExit is raised."""
    import importlib
    import multiprocessing as mp

    threads = threads or max(1, torch.get_num_threads() // world)
    ctx = mp.get_context("spawn")
    # by its module's name, also when this module runs as __main__
    target = target or importlib.import_module(".run",
                                               __package__)._rank_main
    with tempfile.TemporaryDirectory() as tmp:
        url = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=target,
                             args=(r, world, list(argv), url, threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        failed = None
        try:
            while failed is None and any(p.is_alive() for p in procs):
                for r, p in enumerate(procs):
                    p.join(timeout=0.2)
                    if p.exitcode not in (None, 0):
                        failed = (r, p.exitcode)
                        break
            failed = failed or next(((r, p.exitcode)
                                     for r, p in enumerate(procs)
                                     if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    if failed is not None:
        raise SystemExit(f"--mesh {world}: rank {failed[0]} exited with "
                         f"code {failed[1]}")


def main(argv=None):
    from ..utils.config import load_config

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.mesh > 1 and (args.command not in MESH_AXES or args.profile):
        raise SystemExit(
            f"--mesh {args.mesh}: only train-policy (env axis) and "
            f"train-predictor (batch axis) run over a mesh, and not with "
            f"--profile; {args.command}{' --profile' * args.profile} does "
            f"not")
    cfg = load_config(args.config, args.overrides)
    os.makedirs(cfg.out_dir, exist_ok=True)
    if args.mesh > 1:
        _device.resolve(args.device)          # no card: refuse here
        return launch(args.mesh, argv)
    dev = _device.resolve(args.device)
    _device.full_float32(dev)
    return HANDLERS[args.command](cfg, args, dev)


if __name__ == "__main__":
    main()
