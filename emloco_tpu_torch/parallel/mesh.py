"""Env-axis and batch-axis data parallelism over ranks with torch.distributed.

Port of emloco_tpu/parallel/mesh.py (the reference's Horovod plumbing:
run.py:57-72 rank set-up, amp_continuous.py:268-301 averaging, :430-446
optimizer sync). One process per rank; each holds its block of the env (or
batch) axis and a replica of everything else (parameters, optimizer state,
norms, replay ring, generators). An R-rank epoch is the one-rank epoch's
computation:

  * a rank's first env state is its part of the whole env axis's reset
    (`shard_env_axis`, placement by field path), and every random draw over
    the split axis after it is made for the whole axis from the generator
    every rank holds alike, the rank keeping its block (`draw_rows`), so
    the generators advance in lockstep and the rows equal the one-rank
    run's;
  * sums over the split axis (gradients, loss terms, counts, norm
    statistics) are reduced over the ranks; every gather is an all-reduce
    over a zero-padded buffer (`gather`), which NCCL and gloo both take, so
    one code path serves both backends.

Adding the zeros of the padding is exact, and every rank receives the same
reduced bits, so replicated state stays bit-equal on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

# EnvState fields that are not per-env though they live in the env state:
# the generator, the DR clock, the per-motion hard-negative bookkeeping
# (leading dim the motion count, which can equal num_envs: so placement is
# decided by field path, never by shape) and the getup curriculum scalars.
REPLICATED_ENV_STATE_FIELDS = frozenset({
    "rng", "dr_clock",
    "motion_weights", "motion_sampled", "motion_term", "motion_succ",
    "fall_init_prob", "recovery_episode_prob",
})


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in the group: its rank of `size`, the device it
    runs on, the name of the split axis, the process group (None: the
    default group) and, where the launcher knows it, every rank's device."""

    rank: int
    size: int
    device: torch.device
    axis: str = "env"
    group: Any = None
    devices: tuple = ()

    def block(self, n: int) -> slice:
        """This rank's rows of an axis of `n` rows split in equal blocks."""
        if n % self.size:
            raise ValueError(f"{n} rows are not divisible by the "
                             f"{self.size}-rank mesh")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def part(self, n: int) -> slice:
        """This rank's share of `n` replicated rows split by index (the
        first n mod size ranks take one row more)."""
        return slice(n * self.rank // self.size,
                     n * (self.rank + 1) // self.size)


def backend_for(world: int, device: torch.device) -> str:
    """NCCL when every rank has a card of its own; gloo on the CPU and when
    the ranks outnumber the cards (NCCL refuses two ranks on one device;
    gloo reduces CUDA tensors, which stay on the card)."""
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def distributed_init(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "gloo"):
    """Multi-process bring-up: `torch.distributed.init_process_group` with
    `coordinator` ("host:port", or any init_method URL such as
    "file:///path"), the world size and this process's rank. A no-op for
    one process. A failed init raises."""
    if not num_processes or num_processes <= 1:
        return
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def make_mesh(n_devices: Optional[int] = None, axis: str = "env",
              device=None) -> Mesh:
    """The Mesh of this process in the default group (rank 0 of 1 when no
    group is initialized); `n_devices`, where given, must be the group's
    size."""
    size = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a {n_devices}-rank mesh in a group of {size}")
    dev = torch.device("cpu" if device is None else device)
    return Mesh(rank=rank, size=size, device=dev, axis=axis)


def _split(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.size > 1


def draw_rows(fn, shape, mesh: Optional[Mesh], *args, **kw):
    """A draw over a leading axis that `mesh` splits in equal blocks:
    `fn(*args, whole, **kw)` for the whole axis, whole = (shape[0] ·
    ranks,) + shape[1:], of which this rank keeps its block. `shape` is the
    rank's own; without a split, `fn(*args, shape, **kw)`."""
    shape = tuple(shape)
    if not _split(mesh):
        return fn(*args, shape, **kw)
    n = shape[0]
    x = fn(*args, (n * mesh.size,) + shape[1:], **kw)
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of `x` over the ranks (a new tensor); `x` itself without a
    split."""
    if not _split(mesh):
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.group)
    return y


def all_reduce_dict(tensors: dict, mesh: Optional[Mesh]) -> dict:
    """Each tensor of `tensors` summed over the ranks, in one collective
    over their flattened concatenation."""
    if not _split(mesh):
        return tensors
    keys = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1) for k in keys])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    out, i = {}, 0
    for k in keys:
        n = tensors[k].numel()
        out[k] = flat[i:i + n].reshape(tensors[k].shape)
        i += n
    return out


def gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(ranks, *x.shape): every rank's `x`, rank-major, through a sum over
    a zero-padded buffer; (1, *x.shape) without a split."""
    if not _split(mesh):
        return x[None]
    buf = torch.zeros((mesh.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[mesh.rank] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf


def pmean_metrics(metrics: dict, mesh: Optional[Mesh] = None) -> dict:
    """Each 0-d metric averaged over the ranks (Horovod's average_value)."""
    if not _split(mesh):
        return metrics
    keys = list(metrics)
    v = all_reduce_sum(torch.stack([metrics[k].float() for k in keys]),
                       mesh) / mesh.size
    return dict(zip(keys, v))


def barrier(mesh: Optional[Mesh]):
    """Every rank waits here for the others (a one-element all-reduce on
    the rank's device, which both backends take)."""
    if _split(mesh):
        all_reduce_sum(torch.zeros((1,), device=mesh.device), mesh).item()


def check_lockstep(mesh: Optional[Mesh], **replicated):
    """Raises unless each named generator's state and each named dict of
    tensors is the same on every rank (a checksum of each, gathered)."""
    if not _split(mesh):
        return
    sums = []
    for v in replicated.values():
        if isinstance(v, torch.Generator):
            s = v.get_state().to(torch.float64)
            w = torch.arange(1, s.numel() + 1, dtype=torch.float64)
            sums += [s.sum(), (s * w).sum()]
        else:
            sums += [torch.stack([t.double().sum()
                                  for t in v.values()]).sum().cpu()]
    mine = torch.stack(sums).to(mesh.device)
    allr = gather(mine, mesh)
    if not bool((allr == mine[None]).all()):
        raise RuntimeError(
            f"rank {mesh.rank}: replicated state differs between ranks "
            f"({', '.join(replicated)}): checksums {allr.tolist()}")


def shard_env_axis(tree: Any, mesh: Mesh, num_envs: int) -> Any:
    """This rank's part of `tree` by field path: the leaves inside an
    `env_state` field (or of an EnvState passed as the root) are per-env
    and keep this rank's block of rows, except the fields of
    REPLICATED_ENV_STATE_FIELDS; every other leaf (parameters, optimizer
    state, norms, replay ring) is replicated and returned as it is.

    Placement is decided by field path, not by shape: a buffer whose leading
    dim happens to equal num_envs stays replicated. A per-env leaf whose
    leading dim is not num_envs raises ValueError, and so does a num_envs
    that the mesh does not divide."""
    if num_envs % mesh.size:
        r = num_envs % mesh.size
        raise ValueError(
            f"num_envs={num_envs} is not divisible by the {mesh.size}-rank "
            f"mesh; choose an env count that is a multiple of the rank "
            f"count (e.g. {num_envs - r} or {num_envs + mesh.size - r})")
    rows = mesh.block(num_envs)
    root_is_env_state = hasattr(tree, "physics") and hasattr(tree,
                                                            "amp_obs_hist")

    def place(names, leaf):
        if root_is_env_state:
            rel = names
        elif "env_state" in names:
            rel = names[names.index("env_state") + 1:]
        else:
            rel = None
        if not rel or rel[0] in REPLICATED_ENV_STATE_FIELDS or leaf is None:
            return leaf
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 1 \
                or leaf.shape[0] != num_envs:
            raise ValueError(
                f"env_state field {'.'.join(names)} has shape "
                f"{tuple(getattr(leaf, 'shape', ()))}, expected leading dim "
                f"num_envs={num_envs}; if this field is not per-env, add it "
                f"to REPLICATED_ENV_STATE_FIELDS")
        return leaf[rows]

    def walk(names, node):
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: walk(names + [f.name], getattr(node, f.name))
                for f in dataclasses.fields(node)})
        if isinstance(node, dict):
            return {k: walk(names + [k], v) for k, v in node.items()}
        return place(names, node)

    return walk([], tree)
