"""The trainers' optimiser: ``optax.chain(clip_by_global_norm(max_grad_norm),
adam(lr))`` with an optional linear learning-rate decay, as
``pbrl_tpu/train/ppo.py`` builds it; with ``zero_nans``, APG's
``optax.chain(zero_nans(), clip_by_global_norm(...), adam(lr))``
(``pbrl_tpu/train/apg.py``).

Written out rather than taken from ``torch.optim`` and
``clip_grad_norm_``, whose arithmetic differs from optax's:

* the clip spans every parameter passed in (pbrl_tpu clips the policy and
  value params as one tree) and rescales by ``max_norm / norm`` only when
  ``norm >= max_norm``, with no epsilon;
* Adam is optax's (``b1=0.9``, ``b2=0.999``, ``eps=1e-8``, ``eps_root=0``,
  bias-corrected with the incremented count);
* the learning rate is ``linear_schedule(lr, 0.01 * lr, total_updates)``
  read at the count *before* the update, so the first update uses the full
  rate and every update past ``total_updates`` uses 1% of it.

A parameter without a gradient (``fixed_log_std``) counts as a zero
gradient, as under ``stop_gradient``: its moments still decay. ``zero_nans``
replaces each NaN gradient entry by 0 before the clip (infinities stay,
as in optax); the norm :meth:`Adam.step` returns is the raw gradients'.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class Adam:
    learning_rate: float
    max_grad_norm: float
    total_updates: int = 0   # 0: constant learning rate
    zero_nans: bool = False  # NaN gradient entries -> 0 before the clip (APG)
    count: int = 0           # updates applied (optax's adam and schedule counts)
    mu: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    nu: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def lr(self, count: int) -> float:
        """The learning rate at ``count`` (float32, as the optax schedule)."""
        if self.total_updates <= 0:
            return self.learning_rate
        c = np.float32(min(max(count, 0), self.total_updates))
        frac = np.float32(1.0) - c / np.float32(self.total_updates)
        lo = self.learning_rate * 0.01
        return float(np.float32(self.learning_rate - lo) * frac + np.float32(lo))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One update of ``params`` (name -> leaf tensor) from their
        ``.grad``; returns the global norm of the raw gradients."""
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        if not self.mu:
            self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
            self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        raw_norm = norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if self.zero_nans:
            grads = {k: torch.where(torch.isnan(g), 0.0, g) for k, g in grads.items()}
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.max_grad_norm
        lr = self.lr(self.count)
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(self.count))
        for k, p in params.items():
            g = torch.where(keep, grads[k], grads[k] / norm * self.max_grad_norm)
            mu = self.mu[k].mul_(B1).add_((1.0 - B1) * g)
            nu = self.nu[k].mul_(B2).add_((1.0 - B2) * g ** 2)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            p.add_(-lr * upd)
        return raw_norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": {k: v.detach().cpu() for k, v in self.mu.items()},
                "nu": {k: v.detach().cpu() for k, v in self.nu.items()}}

    def load_state_dict(self, sd: dict, device) -> None:
        self.count = int(sd["count"])
        self.mu = {k: torch.as_tensor(v, dtype=torch.float32, device=device).clone()
                   for k, v in sd["mu"].items()}
        self.nu = {k: torch.as_tensor(v, dtype=torch.float32, device=device).clone()
                   for k, v in sd["nu"].items()}
