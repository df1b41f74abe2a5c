"""The optimizer step of the agent (`ClipAdam`) and the trajectory
predictors (`ClipAdamDecay`): optax's chain(clip_by_global_norm(max_norm),
adam(lr)), lr constant or optax's staircase exponential_decay, over every
leaf of a dict of parameters at once, and optionally dropped whole
(parameters, moments and count) where any gradient is nonfinite.

  clip_adam        — the wrapper: on a CUDA tensor the hand-written kernel
                     (`csrc/clip_adam.cu`, two launches, no host sync) or
                     an error; on a CPU tensor `clip_adam_plain`
  clip_adam_plain  — the same step as per-leaf PyTorch ops (`clip`, then
                     amp_agent's `adam_directions`), the CPU path and the
                     kernel's reference

The kernel writes the new parameters and both moments into three fresh flat
buffers (each leaf at a 16-byte boundary) and returns dicts of views into
them by name; the input dicts are left as they were. It repeats the plain
version's roundings element by element; only the global norm's sum runs in
another order, so where the clip engages the two may part by the norm's few
ulp. The kernel takes at most 256 leaves.
"""
from __future__ import annotations

import ctypes
import functools
from operator import attrgetter

import numpy as np
import torch

# fused steps since the last reset (two kernel launches each; the plain
# path adds none)
LAUNCHES = {"clip_adam": 0}

def reset_launch_counts():
    LAUNCHES["clip_adam"] = 0


def exponential_decay(count: torch.Tensor, lr: float, transition_steps: int,
                      decay: float) -> torch.Tensor:
    """optax.exponential_decay(lr, transition_steps, decay,
    staircase=True) at the int32 step `count`, in float32."""
    p = torch.floor(count.float() / transition_steps)
    return lr * torch.pow(torch.tensor(decay, device=count.device), p)


def clip(grads: dict, max_norm: float) -> dict:
    """optax clip_by_global_norm: scales by max_norm / norm only when
    norm ≥ max_norm (no 1e-6, unlike clip_grad_norm_)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, g, g / norm * max_norm)
            for k, g in grads.items()}


def clip_adam_plain(grads: dict, params: dict, count: torch.Tensor,
                    mu: dict, nu: dict, max_norm: float, lr: float,
                    decay: tuple | None = None, guard: bool = False):
    """`clip_adam` as per-leaf PyTorch ops; same arguments and results."""
    from .amp_agent import AdamState, adam_directions  # imports this module
    finite = torch.stack([torch.isfinite(g).all()
                          for g in grads.values()]).all()
    step = -lr if decay is None else -exponential_decay(count, lr, *decay)
    state, u = adam_directions(clip(grads, max_norm),
                               AdamState(count=count, mu=mu, nu=nu))
    new_p = {k: params[k] + d * step for k, d in u.items()}
    count1, new_mu, new_nu = state.count, state.mu, state.nu
    if not guard:
        return new_p, count1, new_mu, new_nu, finite

    def keep(new, old):
        return {k: torch.where(finite, new[k], old[k]) for k in old}

    return (keep(new_p, params), torch.where(finite, count1, count),
            keep(new_mu, mu), keep(new_nu, nu), finite)


def clip_adam(grads: dict, params: dict, count: torch.Tensor, mu: dict,
              nu: dict, max_norm: float, lr: float,
              decay: tuple | None = None, guard: bool = False):
    """One step of optax's chain(clip_by_global_norm(max_norm), adam(rate))
    on dicts of tensors keyed as `params`: rate lr, or with
    `decay=(transition_steps, rate)` lr·rate^⌊count / transition_steps⌋
    at the count before the step. With `guard` a nonfinite gradient anywhere
    leaves parameters, moments and count as they were. Returns (params,
    count, mu, nu, finite), `finite` a 0-d bool tensor on the device. The
    parameters' device chooses the path."""
    if decay is not None and decay[0] < 1:
        raise ValueError(f"transition_steps must be ≥ 1, got {decay[0]}")
    if not params:
        raise ValueError("there must be some parameters")
    if next(iter(params.values())).device.type == "cpu":
        dtypes = {t.dtype for d in (grads, params, mu, nu)
                  for t in d.values()}
        if len(dtypes) > 1:
            raise TypeError(f"mixed dtypes {sorted(map(str, dtypes))}: "
                            "every leaf, gradient and moment must have one "
                            "dtype")
        return clip_adam_plain(grads, params, count, mu, nu, max_norm, lr,
                               decay, guard)
    return _clip_adam_cuda(grads, params, count, mu, nu, max_norm, lr, decay,
                           guard)


@functools.lru_cache(maxsize=None)
def _plan() -> tuple[int, int]:
    """(the most leaves, the partials) from the kernel's C plan."""
    from .. import build
    out = (ctypes.c_int * 2)()
    build.load().emloco_clip_adam_shape(out)
    return out[0], out[1]


@functools.lru_cache(maxsize=64)
def _layout(shapes: tuple, itemsize: int):
    """The flat buffers' layout for leaves of `shapes`: the leaves of one
    shape side by side, so that one view op a shape makes all their views,
    each leaf on a 16-byte boundary. Returns (each leaf's element count,
    as ints and as the C table's row; its offset, the table's row; elements
    a buffer; per shape whether it has more than one leaf and the (shape,
    stride, offset) of its leaves stacked on a first axis; each leaf's place
    among the views)."""
    vec = 16 // itemsize
    by_shape = {}
    for i, shape in enumerate(shapes):
        by_shape.setdefault(shape, []).append(i)
    offsets, stacks, order, total = [0] * len(shapes), [], [], 0
    for shape, leaves in by_shape.items():
        step = -(-shape.numel() // vec) * vec
        stride = torch.empty(shape, device="meta").stride()
        stacks.append((len(leaves) > 1, (len(leaves), *shape),
                       (step, *stride), total))
        for j, i in enumerate(leaves):
            offsets[i] = total + j * step
        total += len(leaves) * step
        order += leaves
    place = [0] * len(shapes)
    for j, i in enumerate(order):
        place[i] = j
    sizes = [shape.numel() for shape in shapes]
    return (sizes, np.asarray(sizes, np.int64), np.asarray(offsets, np.int64),
            total, tuple(stacks), tuple(place))


def _views(out: torch.Tensor, names: list, total: int, stacks: tuple,
           place: tuple):
    """The three dicts of views by name into `out`'s three buffers of
    `total` elements (`_layout`'s stacks and places)."""
    dicts = []
    for j in range(3):
        flat = []
        for many, shape, stride, off in stacks:
            if many:
                flat += out.as_strided(shape, stride,
                                       off + j * total).unbind(0)
            else:
                flat.append(out.as_strided(shape[1:], stride[1:],
                                           off + j * total))
        dicts.append(dict(zip(names, map(flat.__getitem__, place))))
    return dicts


def _clip_adam_cuda(grads, params, count, mu, nu, max_norm, lr, decay,
                    guard):
    from .. import build
    if grads.keys() != params.keys():
        raise ValueError("the gradients must name the parameters")
    names = list(params)
    ps = list(params.values())
    gs, ms, vs = ([d[k] for k in names] for d in (grads, mu, nu))
    # the C table's row order; a leaf in another layout (cuDNN's
    # channels-last gradient of a conv weight) is copied to the row-major
    # one the kernel reads
    leaves = [t if t.is_contiguous() else t.contiguous()
              for t in gs + ps + ms + vs]
    dev, dtype = ps[0].device, ps[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"parameters must be float32 or float64, got "
                        f"{dtype}")
    if set(map(attrgetter("dtype"), leaves)) != {dtype}:
        raise TypeError(f"mixed dtypes: every leaf, gradient and moment "
                        f"must be {dtype}")
    if count.dtype != torch.int32 or count.dim() != 0:
        raise TypeError("count must be a 0-d int32 tensor")
    if (set(map(torch.Tensor.get_device, leaves)) != {ps[0].get_device()}
            or count.device != dev):
        raise ValueError(f"every tensor, the count too, must lie on {dev}")
    cap, partials = _plan()
    if len(names) > cap:
        raise ValueError(f"the kernel takes at most {cap} leaves, got "
                         f"{len(names)}")
    sizes, n_row, off_row, total, stacks, place = _layout(
        tuple(map(attrgetter("shape"), ps)), ps[0].element_size())
    if any(list(map(torch.Tensor.numel, ts)) != sizes for ts in (gs, ms, vs)):
        raise ValueError("gradients and moments must have their "
                         "parameters' sizes")
    table = np.empty((6, len(names)), np.int64)
    table[:4] = np.asarray(list(map(torch.Tensor.data_ptr, leaves)),
                           np.int64).reshape(4, -1)
    table[4], table[5] = n_row, off_row
    out = torch.empty(3 * total, dtype=dtype, device=dev)
    count_out = torch.empty((), dtype=torch.int32, device=dev)
    finite = torch.empty((), dtype=torch.bool, device=dev)
    work = torch.empty(partials * 12, dtype=torch.uint8, device=dev)
    steps, rate = (0, 1.0) if decay is None else decay
    with torch.cuda.device(dev):
        err = build.load().emloco_clip_adam(
            ps[0].element_size(), len(names), table.ctypes.data,
            count.data_ptr(), out.data_ptr(), total, count_out.data_ptr(),
            finite.data_ptr(), max_norm, lr, steps, rate, int(guard),
            work.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"clip_adam kernel: CUDA error {err}")
    LAUNCHES["clip_adam"] += 1
    new_p, new_mu, new_nu = _views(out, names, total, stacks, place)
    return new_p, count_out, new_mu, new_nu, finite
