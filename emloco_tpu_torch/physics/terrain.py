"""Heightfield terrain: height/normal queries + host-side generators.

Port of emloco_tpu/physics/terrain.py. The heightfield itself is the
collision representation: contact and the height-map sensor read the same
(H, W) grid through the packed corner texture. The generators are numpy and
are copied here (the JAX module imports jax and flax); with the same seed
they give the same heights. The walkable mask and spawn table use the numpy
path of emloco_tpu/native/terrain.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as _device
from ..struct import TensorStruct


@dataclasses.dataclass(frozen=True)
class Heightfield(TensorStruct):
    """Static world geometry shared across envs."""

    heights: torch.Tensor                 # (H, W) float32 meters
    cell: float = 0.1
    origin: tuple = (0.0, 0.0)
    spawnable_xy: torch.Tensor = None     # (S, 2) spawn table
    corner_tex: torch.Tensor = None       # (H-1, W-1, 4): h00,h10,h01,h11

    @property
    def shape(self):
        return tuple(self.heights.shape)


def make_heightfield(heights, cell, origin, spawnable_xy,
                     device=None) -> Heightfield:
    """Build a Heightfield with its packed corner texture from an (H, W)
    grid."""
    dev = _device.resolve(device)
    h = torch.as_tensor(np.asarray(heights, np.float32), device=dev)
    h00, h10 = h[:-1, :-1], h[1:, :-1]
    h01, h11 = h[:-1, 1:], h[1:, 1:]
    return Heightfield(
        heights=h, cell=cell, origin=tuple(origin),
        spawnable_xy=torch.as_tensor(np.asarray(spawnable_xy, np.float32),
                                     device=dev),
        corner_tex=torch.stack([h00, h10, h01, h11], dim=-1).contiguous(),
    )


def flat_terrain(extent: float = 40.0, cell: float = 0.1,
                 device=None) -> Heightfield:
    """A flat (extent/cell)² grid at height 0 centred on the origin."""
    n = int(extent / cell)
    return make_heightfield(np.zeros((n, n), np.float32), cell,
                            (-extent / 2, -extent / 2),
                            np.zeros((1, 2), np.float32), device=device)


def _grid_coords_xy(hf: Heightfield, x, y):
    """World x/y component arrays → fractional grid coords, clamped."""
    H, W = hf.shape
    gx = torch.clamp((x - hf.origin[0]) / hf.cell, 0.0, H - 1.001)
    gy = torch.clamp((y - hf.origin[1]) / hf.cell, 0.0, W - 1.001)
    return gx, gy


def _bilinear_parts(hf: Heightfield, xy: torch.Tensor):
    gx, gy = _grid_coords_xy(hf, xy[..., 0], xy[..., 1])
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    return x0, y0, gx - x0, gy - y0


def _corners(hf: Heightfield, x0, y0):
    t = hf.corner_tex[x0, y0]                            # (..., 4)
    return t[..., 0], t[..., 1], t[..., 2], t[..., 3]


def height_at_min2_xy(hf: Heightfield, x, y) -> torch.Tensor:
    """Conservative 2-point min lookup, min(h00, h11), of the cell under
    each query (the reference sensor's lookup)."""
    gx, gy = _grid_coords_xy(hf, x, y)
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    W = hf.corner_tex.shape[1]
    t = hf.corner_tex.reshape(-1, 4)[x0 * W + y0]
    return torch.minimum(t[..., 0], t[..., 3])


def height_at_min2(hf: Heightfield, xy: torch.Tensor) -> torch.Tensor:
    return height_at_min2_xy(hf, xy[..., 0], xy[..., 1])


def _bilinear(h00, h10, h01, h11, fx, fy):
    return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
            + h01 * (1 - fx) * fy + h11 * fx * fy)


def height_at(hf: Heightfield, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear height at world xy (..., 2) → (...)."""
    x0, y0, fx, fy = _bilinear_parts(hf, xy)
    return _bilinear(*_corners(hf, x0, y0), fx, fy)


def _normal_from_corners(hf, h00, h10, h01, h11, fx, fy):
    dhdx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / hf.cell
    dhdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / hf.cell
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def normal_at(hf: Heightfield, xy: torch.Tensor) -> torch.Tensor:
    """Outward unit surface normal of the bilinear surface."""
    x0, y0, fx, fy = _bilinear_parts(hf, xy)
    return _normal_from_corners(hf, *_corners(hf, x0, y0), fx, fy)


def height_and_normal_at(hf: Heightfield, xy: torch.Tensor):
    """Fused bilinear height + surface normal (one corner fetch)."""
    x0, y0, fx, fy = _bilinear_parts(hf, xy)
    c = _corners(hf, x0, y0)
    return _bilinear(*c, fx, fy), _normal_from_corners(hf, *c, fx, fy)


def corner_patch(hf: Heightfield, center_xy: torch.Tensor, size: int):
    """Per-env window of the corner texture around `center_xy` (N, 2):
    (patch (N, sx, sy, 4), xb (N,), yb (N,)) with sx = min(size, H-1), sy =
    min(size, W-1) and the window's first cell (xb, yb) clamped into
    [0, H-1-sx] × [0, W-1-sy], as the JAX engine's dynamic slice clamps
    it."""
    gx, gy = _grid_coords_xy(hf, center_xy[..., 0], center_xy[..., 1])
    H, W = hf.shape
    sx = min(size, H - 1)
    sy = min(size, W - 1)
    xb = torch.clamp(torch.floor(gx).long() - sx // 2, 0, H - 1 - sx)
    yb = torch.clamp(torch.floor(gy).long() - sy // 2, 0, W - 1 - sy)
    dev = center_xy.device
    ix = xb[:, None, None] + torch.arange(sx, device=dev)[None, :, None]
    iy = yb[:, None, None] + torch.arange(sy, device=dev)[None, None, :]
    return hf.corner_tex[ix, iy], xb, yb


def height_and_normal_at_patch(hf: Heightfield, patch, xb, yb,
                               xy: torch.Tensor, return_oob: bool = False):
    """height_and_normal_at through a corner_patch window: each query's cell
    is clamped into its env's window and read there (the JAX engine picks it
    with two one-hot contractions; both select the same four corners, so the
    result is bit-equal to the global lookup wherever the cell lies inside
    the window). With `return_oob` also the (N, C) bool mask of the queries
    whose cell fell outside the window and was clamped to its edge."""
    x0, y0, fx, fy = _bilinear_parts(hf, xy)              # (N, C)
    sx, sy = patch.shape[1], patch.shape[2]
    rx = x0 - xb[:, None]
    ry = y0 - yb[:, None]
    lx = torch.clamp(rx, 0, sx - 1)
    ly = torch.clamp(ry, 0, sy - 1)
    env = torch.arange(patch.shape[0], device=patch.device)[:, None]
    t = patch[env, lx, ly]                                # (N, C, 4)
    c = (t[..., 0], t[..., 1], t[..., 2], t[..., 3])
    h = _bilinear(*c, fx, fy)
    n = _normal_from_corners(hf, *c, fx, fy)
    if return_oob:
        return h, n, (rx != lx) | (ry != ly)
    return h, n


# ---------------------------------------------------------------------------
# Host-side procedural generators (numpy)
# ---------------------------------------------------------------------------

def gen_random_uniform(shape, cell, min_h=-0.1, max_h=0.1, step=0.025,
                       rng=None):
    rng = rng or np.random.RandomState(0)
    levels = np.arange(min_h, max_h + step, step)
    idx = rng.randint(0, len(levels), size=shape)
    return levels[idx].astype(np.float32)


def gen_sloped(shape, cell, slope=0.2, axis=0):
    H, W = shape
    ramp = np.arange(H if axis == 0 else W, dtype=np.float32) * cell * slope
    return np.broadcast_to(ramp[:, None] if axis == 0 else ramp[None, :],
                           shape).copy()


def gen_pyramid_sloped(shape, cell, slope=0.2):
    H, W = shape
    x = np.minimum(np.arange(H), H - 1 - np.arange(H)).astype(np.float32)
    y = np.minimum(np.arange(W), W - 1 - np.arange(W)).astype(np.float32)
    return (np.minimum(x[:, None], y[None, :]) * cell * slope).astype(
        np.float32)


def gen_discrete_obstacles(shape, cell, max_h=0.15, min_size=0.8,
                           max_size=1.6, num_rects=24, rng=None):
    rng = rng or np.random.RandomState(0)
    H, W = shape
    out = np.zeros(shape, np.float32)
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / cell)
        h = int(rng.uniform(min_size, max_size) / cell)
        x = rng.randint(0, max(1, H - h))
        y = rng.randint(0, max(1, W - w))
        out[x:x + h, y:y + w] = rng.choice(
            [-max_h, -max_h / 2, max_h / 2, max_h])
    return out


def gen_wave(shape, cell, num_waves=2, amplitude=0.15):
    H, W = shape
    x = np.linspace(0, num_waves * 2 * np.pi, H)
    y = np.linspace(0, num_waves * 2 * np.pi, W)
    return (amplitude * (np.sin(x)[:, None] + np.cos(y)[None, :]) / 2).astype(
        np.float32)


def gen_stairs(shape, cell, step_width=0.75, step_height=0.15):
    H, W = shape
    sw = max(1, int(step_width / cell))
    steps = (np.arange(H) // sw).astype(np.float32) * step_height
    return np.broadcast_to(steps[:, None], shape).copy()


def gen_pyramid_stairs(shape, cell, step_width=0.75, step_height=0.12):
    H, W = shape
    sw = max(1, int(step_width / cell))
    x = np.minimum(np.arange(H), H - 1 - np.arange(H))
    y = np.minimum(np.arange(W), W - 1 - np.arange(W))
    ring = np.minimum(x[:, None], y[None, :]) // sw
    return (ring * step_height).astype(np.float32)


def gen_stepping_stones(shape, cell, stone_size=0.8, spacing=0.4, height=0.1,
                        depth=-0.5, rng=None):
    rng = rng or np.random.RandomState(0)
    H, W = shape
    out = np.full(shape, depth, np.float32)
    pitch = max(1, int((stone_size + spacing) / cell))
    size = max(1, int(stone_size / cell))
    for i in range(0, H, pitch):
        off = rng.randint(0, pitch)
        for j in range(-pitch, W, pitch):
            jj = j + off
            if jj < 0 or jj + size > W:
                continue
            out[i:i + size, jj:jj + size] = rng.uniform(-height, height)
    return out


def gen_poles(shape, cell, num_poles=40, radius=0.15, height=2.0, rng=None):
    """Square vertical poles of half-width `radius` and `height` at random
    centres."""
    rng = rng or np.random.RandomState(0)
    H, W = shape
    out = np.zeros(shape, np.float32)
    rr = max(1, int(radius / cell))
    for _ in range(num_poles):
        cx, cy = rng.randint(rr, H - rr), rng.randint(rr, W - rr)
        out[cx - rr:cx + rr, cy - rr:cy + rr] = height
    return out


_GENERATORS = {
    "random_uniform": gen_random_uniform,
    "sloped": gen_sloped,
    "pyramid_sloped": gen_pyramid_sloped,
    "discrete_obstacles": gen_discrete_obstacles,
    "wave": gen_wave,
    "stairs": gen_stairs,
    "pyramid_stairs": gen_pyramid_stairs,
    "stepping_stones": gen_stepping_stones,
    "poles": gen_poles,
}


def walkable_mask(heights: np.ndarray, cell: float, max_slope: float = 0.5,
                  margin_cells: int = 3) -> np.ndarray:
    """Cells whose local slope is below max_slope, eroded by a margin."""
    gx, gy = np.gradient(heights, cell)
    bad = (np.abs(gx) >= max_slope) | (np.abs(gy) >= max_slope)
    k = margin_cells
    H, W = heights.shape
    padded = np.pad(bad, k, constant_values=True)
    rows = np.zeros((H, W + 2 * k), bool)
    for dx in range(-k, k + 1):
        rows |= padded[k + dx:k + dx + H, :]
    out = np.zeros((H, W), bool)
    for dy in range(-k, k + 1):
        out |= rows[:, k + dy:k + dy + W]
    return ~out


def spawn_table(mask: np.ndarray, cell: float, origin, max_pts: int = 65536,
                seed: int = 0) -> np.ndarray:
    """World xy of every walkable cell, subsampled to max_pts."""
    xs, ys = np.where(mask)
    xy = np.stack([xs * cell + origin[0], ys * cell + origin[1]],
                  -1).astype(np.float32)
    if len(xy) == 0:
        return np.zeros((1, 2), np.float32)
    if len(xy) > max_pts:
        rng = np.random.RandomState(seed)
        xy = xy[rng.choice(len(xy), max_pts, replace=False)]
    return xy


def generate_mixed_terrain(
    map_length: float = 8.0,
    num_tiles: int = 8,
    cell: float = 0.1,
    proportions=(0.2, 0.1, 0.15, 0.15, 0.05, 0.1, 0.15, 0.1),
    types=("random_uniform", "sloped", "pyramid_sloped", "discrete_obstacles",
           "wave", "stairs", "pyramid_stairs", "stepping_stones"),
    difficulty: float = 1.0,
    seed: int = 0,
    border_cells: int = 10,
    curriculum: bool = False,
    device=None,
) -> Heightfield:
    """num_tiles × num_tiles sub-terrains, type sampled by proportions,
    difficulty scaling heights and slopes, plus a flat border."""
    dev = _device.resolve(device)
    rng = np.random.RandomState(seed)
    tile = int(map_length / cell)
    n = num_tiles * tile + 2 * border_cells
    big = np.zeros((n, n), np.float32)
    cum = np.cumsum(proportions) / np.sum(proportions)
    for i in range(num_tiles):
        for j in range(num_tiles):
            u = rng.rand()
            t = types[int(np.searchsorted(cum, u))]
            if curriculum:
                d = difficulty * (i + 1) / num_tiles
            else:
                d = difficulty * rng.uniform(0.4, 1.0)
            kwargs = {}
            if t == "random_uniform":
                kwargs = dict(min_h=-0.08 * d, max_h=0.08 * d, rng=rng)
            elif t in ("sloped", "pyramid_sloped"):
                kwargs = dict(slope=0.35 * d)
            elif t == "discrete_obstacles":
                kwargs = dict(max_h=0.12 * d, rng=rng)
            elif t == "wave":
                kwargs = dict(amplitude=0.12 * d)
            elif t in ("stairs", "pyramid_stairs"):
                kwargs = dict(step_height=0.10 * d)
            elif t == "stepping_stones":
                kwargs = dict(height=0.05 * d, depth=-0.2 * d, rng=rng)
            patch = _GENERATORS[t]((tile, tile), cell, **kwargs)
            x0 = border_cells + i * tile
            y0 = border_cells + j * tile
            big[x0:x0 + tile, y0:y0 + tile] = patch

    mask = walkable_mask(big, cell)
    extent = n * cell
    origin = (-extent / 2, -extent / 2)
    xy = spawn_table(mask, cell, origin, max_pts=65536, seed=seed)
    return make_heightfield(big, cell, origin, xy, device=dev)
