"""Running observation statistics (counterpart of
``pbrl_tpu/train/running_stats.py``).

``update`` takes pbrl_tpu's ``axis_name`` as ``group``: the process group
whose ranks hold the rest of the batch, over which the batch moments are
all-reduced before the merge, so that every rank holds the statistics of
the whole batch.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


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


def update(stats: RunningStats, batch: torch.Tensor, group=None) -> RunningStats:
    """Merge a (..., dim) batch of observations (Chan's parallel update).
    With ``group``, each of its ranks holds an equal share of the batch:
    the mean of the shares' means, and the sum of their ``M2`` about it,
    are all-reduced (pbrl_tpu's ``pmean`` and ``psum``)."""
    flat = batch.reshape(-1, batch.shape[-1])
    n_b = float(flat.shape[0])
    mean_b = torch.mean(flat, dim=0)
    m2_b = torch.sum((flat - mean_b) ** 2, dim=0)
    if group is not None:
        k = dist.get_world_size(group)
        mean_all = mean_b.clone()
        dist.all_reduce(mean_all, group=group)
        mean_all /= k
        # total M2 = sum_i [m2_i + n_i (mean_i - mean_all)^2]
        m2_b = m2_b + n_b * (mean_b - mean_all) ** 2
        dist.all_reduce(m2_b, group=group)
        n_b, mean_b = n_b * k, mean_all
    delta = mean_b - stats.mean
    tot = stats.count + n_b
    new_mean = stats.mean + delta * n_b / tot
    new_m2 = stats.m2 + m2_b + delta ** 2 * stats.count * n_b / tot
    return RunningStats(count=tot, mean=new_mean, m2=new_m2)


def normalize(stats: RunningStats, obs: torch.Tensor) -> torch.Tensor:
    return torch.clamp((obs - stats.mean) / stats.std, -10.0, 10.0)
