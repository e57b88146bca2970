"""Actor-critic networks (counterpart of ``pbrl_tpu/train/networks.py``).

DeepMimic-scale MLPs (1024-512 hidden, swish). Module names follow flax's
parameter tree (``torso.hidden_0``, ``torso.hidden_1``, ``torso.out``,
``log_std``) so a flax checkpoint maps onto the ``state_dict`` one to one
(:mod:`pbrl_tpu_torch.train.checkpoint`). :func:`init_params` draws what
flax's ``init_params`` draws: ``nn.Dense``'s default kernel (lecun normal,
a normal truncated at two standard deviations and scaled to variance
1/fan_in) with zero bias, and ``log_std`` at ``init_log_std``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling divisor)
_TRUNC_STD = 0.87962566103423978


class MLP(nn.Module):
    def __init__(self, in_size: int, features: Sequence[int]):
        super().__init__()
        sizes = [in_size, *features]
        for i in range(len(features) - 1):
            self.add_module(f"hidden_{i}", nn.Linear(sizes[i], sizes[i + 1]))
        self.out = nn.Linear(sizes[-2], sizes[-1])
        self.n_hidden = len(features) - 1

    def forward(self, x):
        for i in range(self.n_hidden):
            x = nn.functional.silu(getattr(self, f"hidden_{i}")(x))
        return self.out(x)


class PolicyNetwork(nn.Module):
    """Gaussian policy: MLP mean + state-independent log-std, clamped to
    [min_log_std, max_log_std] (sigma in [0.1, 2.0] rad). With
    ``fixed_log_std`` no gradient flows to the std; on a fresh run it stays
    at ``init_log_std``, but after a resume that restores non-zero Adam
    moments those moments still move it, as in pbrl_tpu."""

    def __init__(self, obs_size: int, action_size: int, hidden: Sequence[int] = (1024, 512),
                 init_log_std: float = -1.0, fixed_log_std: bool = False,
                 min_log_std: float = -2.3, max_log_std: float = 0.7):
        super().__init__()
        self.torso = MLP(obs_size, (*hidden, action_size))
        self.log_std = nn.Parameter(torch.full((action_size,), float(init_log_std)))
        self.fixed_log_std = fixed_log_std
        self.min_log_std = min_log_std
        self.max_log_std = max_log_std

    def clamped_log_std(self):
        """The (action_size,) log-std every row of the batch uses."""
        log_std = self.log_std.detach() if self.fixed_log_std else self.log_std
        return torch.clamp(log_std, self.min_log_std, self.max_log_std)

    def forward(self, obs):
        mean = self.torso(obs)
        return mean, self.clamped_log_std().expand_as(mean)


class ValueNetwork(nn.Module):
    def __init__(self, obs_size: int, hidden: Sequence[int] = (1024, 512)):
        super().__init__()
        self.torso = MLP(obs_size, (*hidden, 1))

    def forward(self, obs):
        return self.torso(obs)[..., 0]


@torch.no_grad()
def flax_dense_init_(module: nn.Module, generator: Optional[torch.Generator] = None):
    """Re-draw every ``nn.Linear`` of ``module`` as flax's ``nn.Dense``
    default: lecun-normal weight, zero bias."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.weight.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            m.bias.zero_()
    return module


def init_params(obs_size: int, action_size: int, hidden=(1024, 512),
                init_log_std: float = -1.0, fixed_log_std: bool = False,
                generator: Optional[torch.Generator] = None, device="cuda"):
    """(policy, value) on ``device``, drawn from ``generator`` (policy
    first) with flax's default initialisers."""
    dev = generator.device if generator is not None else device
    policy = PolicyNetwork(obs_size, action_size, hidden, init_log_std=init_log_std,
                           fixed_log_std=fixed_log_std).to(dev)
    value = ValueNetwork(obs_size, hidden).to(dev)
    flax_dense_init_(policy, generator)
    flax_dense_init_(value, generator)
    return policy.to(device), value.to(device)


# ---------------------------------------------------------------------------
# Gaussian distribution helpers
# ---------------------------------------------------------------------------


def sample_action(mean, log_std, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None):
    """``mean + exp(log_std) * noise``; ``noise`` is a standard-normal draw
    of ``mean``'s shape, drawn from ``generator`` when not given."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    return mean + torch.exp(log_std) * noise


def log_prob(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z ** 2 - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


def entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
