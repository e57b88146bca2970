"""Running observation statistics (counterpart of
``pbrl_tpu/train/running_stats.py``).

One card: ``update`` merges the batch with no cross-device reduction
(pbrl_tpu's ``axis_name`` psum waits for the data-parallel port).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RunningStats:
    count: torch.Tensor  # ()
    mean: torch.Tensor   # (dim,)
    m2: torch.Tensor     # (dim,) sum of squared deviations

    @property
    def std(self) -> torch.Tensor:
        var = self.m2 / torch.clamp(self.count, min=2.0)
        return torch.sqrt(torch.clamp(var, min=1e-6))

    def to(self, device) -> "RunningStats":
        return RunningStats(self.count.to(device), self.mean.to(device), self.m2.to(device))


def init(dim: int, device="cuda") -> RunningStats:
    """Zero count and mean; ``m2`` starts at ones, as pbrl_tpu's does."""
    return RunningStats(count=torch.zeros((), device=device),
                        mean=torch.zeros((dim,), device=device),
                        m2=torch.ones((dim,), device=device))


def update(stats: RunningStats, batch: torch.Tensor) -> RunningStats:
    """Merge a (..., dim) batch of observations (Chan's parallel update)."""
    flat = batch.reshape(-1, batch.shape[-1])
    n_b = float(flat.shape[0])
    mean_b = torch.mean(flat, dim=0)
    m2_b = torch.sum((flat - mean_b) ** 2, dim=0)
    delta = mean_b - stats.mean
    tot = stats.count + n_b
    new_mean = stats.mean + delta * n_b / tot
    new_m2 = stats.m2 + m2_b + delta ** 2 * stats.count * n_b / tot
    return RunningStats(count=tot, mean=new_mean, m2=new_m2)


def normalize(stats: RunningStats, obs: torch.Tensor) -> torch.Tensor:
    return torch.clamp((obs - stats.mean) / stats.std, -10.0, 10.0)
