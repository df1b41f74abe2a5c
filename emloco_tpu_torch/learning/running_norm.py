"""Running mean/std normalization (port of
emloco_tpu/learning/running_norm.py): parallel Welford updates; freezing is
simply not calling `update`."""
from __future__ import annotations

import dataclasses

import torch

from .. import device as _device
from ..struct import TensorStruct


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

    def update(self, batch: torch.Tensor) -> "RunningNorm":
        batch = batch.reshape(-1, batch.shape[-1])
        b_mean = batch.mean(0)
        b_var = batch.var(0, unbiased=False)
        b_count = batch.shape[0]
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
