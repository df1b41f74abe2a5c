"""Running mean/std normalization (port of
emloco_tpu/learning/running_norm.py): parallel Welford updates; freezing is
simply not calling `update`."""
from __future__ import annotations

import dataclasses

import torch

from .. import device as _device
from ..parallel import mesh as pmesh
from ..struct import TensorStruct


def moments(rows: torch.Tensor, mesh=None):
    """(count, mean, population variance) over the rows of `rows` (M, D):
    with a `mesh`, over every rank's rows, each rank's (count, mean, M2)
    gathered and merged in rank order (Chan's parallel update), so every
    rank computes the same bits."""
    count = rows.shape[0]
    mean = rows.mean(0)
    var = rows.var(0, unbiased=False)
    if mesh is None or mesh.size == 1:
        return count, mean, var
    mine = torch.cat([torch.full((1,), float(count), device=rows.device),
                      mean, var * count])
    allr = pmesh.gather(mine, mesh)
    D = rows.shape[1]
    n, m, m2 = allr[0, 0], allr[0, 1:D + 1], allr[0, D + 1:]
    for r in range(1, mesh.size):
        n_r, m_r, m2_r = allr[r, 0], allr[r, 1:D + 1], allr[r, D + 1:]
        tot = n + n_r
        delta = m_r - m
        m = m + delta * n_r / tot
        m2 = m2 + m2_r + delta ** 2 * n * n_r / tot
        n = tot
    return n, m, m2 / n


@dataclasses.dataclass(frozen=True)
class RunningNorm(TensorStruct):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, dim: int, device=None):
        dev = _device.resolve(device)
        return cls(mean=torch.zeros((dim,), device=dev),
                   var=torch.ones((dim,), device=dev),
                   count=torch.tensor(1e-4, dtype=torch.float32, device=dev))

    def update(self, batch: torch.Tensor, mesh=None) -> "RunningNorm":
        """The norm after `batch`'s rows (parallel Welford); with a `mesh`,
        after the rows of every rank's `batch` (`moments`)."""
        b_count, b_mean, b_var = moments(batch.reshape(-1, batch.shape[-1]),
                                         mesh)
        delta = b_mean - self.mean
        tot = self.count + b_count
        new_mean = self.mean + delta * b_count / tot
        m2 = (self.var * self.count + b_var * b_count
              + delta ** 2 * self.count * b_count / tot)
        return self.replace(mean=new_mean, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        y = (x - self.mean) / torch.sqrt(self.var + 1e-5)
        return torch.clamp(y, -clip, clip)

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        return y * torch.sqrt(self.var + 1e-5) + self.mean
