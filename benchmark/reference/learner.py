"""PPO's learner in plain PyTorch: the update of one iteration from a rollout.

The networks are 2-hidden-layer swish MLPs (a Gaussian policy with a
state-independent log-std clamped to [-2.3, 0.7], and a value net), the
observation statistics are Chan's parallel merge, the advantage is GAE,
the loss is the clipped surrogate plus the value term minus the entropy
term over each minibatch, and the optimiser is optax's
``chain(clip_by_global_norm, adam)`` with a linear decay of the rate to 1%
over the run's updates. Weights and optimiser state are read from the
exported learner files (``<clip>_train_state.npz`` and the policy params of
``<clip>_policy.npz``); leaves are named and shaped as the program's
``TrainState.params()`` (a weight is ``(out, in)``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
LOG_STD_RANGE = (-2.3, 0.7)


def _leaves(arrays, prefix):
    out = {}
    for k, v in arrays.items():
        if not k.startswith(prefix) or k.endswith("log_std"):
            continue
        name = k[len(prefix):]  # torso/hidden_0/kernel
        mod, layer, kind = name.split("/")
        if kind == "kernel":
            out[f"{mod}.{layer}.weight"] = np.ascontiguousarray(np.asarray(v, np.float32).T)
        else:
            out[f"{mod}.{layer}.bias"] = np.asarray(v, np.float32)
    return out


class Learner:
    """Params, Adam state and observation statistics of one learner."""

    def __init__(self, policy: str, train_state: str = None, train_config: dict = None,
                 device="cuda"):
        """The policy and its obs statistics from ``policy``; with
        ``train_state``, the whole learner (value net, unclamped log-std,
        Adam state and the learner's obs statistics)."""
        dev = torch.device(device)
        with np.load(policy) as z:
            pol = {k: z[k] for k in z.files}
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev).clone()
        params = {f"policy/{k}": t(v) for k, v in _leaves(pol, "policy/").items()}
        params["policy/log_std"] = t(pol["policy/log_std"])
        self.params = params
        self.stats = [t(pol["obs_stats/count"]), t(pol["obs_stats/mean"]), t(pol["obs_stats/m2"])]
        if train_state is None:
            return
        with np.load(train_state) as z:
            ts = {k: z[k] for k in z.files}
        params["policy/log_std"] = t(ts["policy/log_std"])
        params.update({f"value/{k}": t(v) for k, v in _leaves(ts, "value/").items()})
        self.mu, self.nu = {}, {}
        for which, store in (("mu", self.mu), ("nu", self.nu)):
            for net in ("policy", "value"):
                for k, v in _leaves(ts, f"opt/{which}/{net}/").items():
                    store[f"{net}/{k}"] = t(v)
            store["policy/log_std"] = t(ts[f"opt/{which}/policy/log_std"])
        self.count = int(ts["opt/count"])
        self.stats = [t(ts["obs_stats/count"]), t(ts["obs_stats/mean"]), t(ts["obs_stats/m2"])]
        if train_config["reset_log_std"]:
            params["policy/log_std"].fill_(train_config["init_log_std"])
        self.params = params
        self._configure(train_config)

    @classmethod
    def from_state(cls, state: dict, train_config: dict, device="cuda", dtype=torch.float32):
        """A learner at a given state, copied: ``state`` holds ``params``,
        ``mu`` and ``nu`` (leaf name -> tensor), Adam's ``count`` and the
        observation ``stats`` (count, mean, m2). ``dtype`` float64 makes the
        witness that calibration holds float32 against (``learn`` then
        takes float64 inputs)."""
        self = cls.__new__(cls)
        t = lambda x: x.detach().to(torch.device(device), dtype).clone()
        self.params = {k: t(v) for k, v in state["params"].items()}
        self.mu = {k: t(v) for k, v in state["mu"].items()}
        self.nu = {k: t(v) for k, v in state["nu"].items()}
        self.count = int(state["count"])
        self.stats = [t(s) for s in state["stats"]]
        self._configure(train_config)
        return self

    def _configure(self, train_config: dict):
        self.cfg = train_config
        iters = max(1, train_config["total_env_steps"]
                    // (train_config["num_envs"] * train_config["unroll_length"]))
        self.total_updates = (iters * train_config["update_epochs"] * train_config["num_minibatches"]
                              if train_config["lr_decay"] else 0)

    # -- networks ------------------------------------------------------------
    def _mlp(self, net, x):
        p = self.params
        n_hidden = sum(1 for k in p if k.startswith(f"{net}/torso.hidden_") and k.endswith(".weight"))
        for i in range(n_hidden):
            x = torch.nn.functional.silu(x @ p[f"{net}/torso.hidden_{i}.weight"].t()
                                         + p[f"{net}/torso.hidden_{i}.bias"])
        return x @ p[f"{net}/torso.out.weight"].t() + p[f"{net}/torso.out.bias"]

    def log_std(self):
        return torch.clamp(self.params["policy/log_std"], *LOG_STD_RANGE)

    def policy_mean(self, obs_n):
        return self._mlp("policy", obs_n)

    def value(self, obs_n):
        return self._mlp("value", obs_n)[..., 0]

    def normalize(self, obs, stats=None):
        count, mean, m2 = stats or self.stats
        std = torch.sqrt(torch.clamp(m2 / torch.clamp(count, min=2.0), min=1e-6))
        return torch.clamp((obs - mean) / std, -10.0, 10.0)

    @staticmethod
    def log_prob(mean, log_std, action):
        z = (action - mean) / torch.exp(log_std)
        return torch.sum(-0.5 * z ** 2 - log_std - 0.5 * math.log(2 * math.pi), dim=-1)

    # -- update ----------------------------------------------------------------
    def _merged_stats(self, obs):
        count, mean, m2 = self.stats
        flat = obs.reshape(-1, obs.shape[-1])
        n_b = float(flat.shape[0])
        mean_b = torch.mean(flat, dim=0)
        m2_b = torch.sum((flat - mean_b) ** 2, dim=0)
        delta = mean_b - mean
        tot = count + n_b
        return [tot, mean + delta * n_b / tot, m2 + m2_b + delta ** 2 * count * n_b / tot]

    def _lr(self):
        lr = self.cfg["learning_rate"]
        if self.total_updates <= 0:
            return lr
        c = np.float32(min(max(self.count, 0), self.total_updates))
        frac = np.float32(1.0) - c / np.float32(self.total_updates)
        lo = lr * 0.01
        return float(np.float32(lr - lo) * frac + np.float32(lo))

    @torch.no_grad()
    def _adam(self, grads):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.cfg["max_grad_norm"]
        lr = self._lr()
        self.count += 1
        bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(self.count))
        bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(self.count))
        for k, p in self.params.items():
            g = torch.where(keep, grads[k], grads[k] / norm * self.cfg["max_grad_norm"])
            self.mu[k] = B1 * self.mu[k] + (1.0 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1.0 - B2) * g ** 2
            p -= lr * (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + EPS)

    def learn(self, obs, action, reward, done, final_obs, perms):
        """One iteration's update from a (T, B) rollout (raw ``obs``, the
        taken ``action``, ``reward``, ``done``), the obs after its last
        step (``final_obs``) and the minibatch permutations ``perms``
        (epochs, T*B). Returns (metrics, the first minibatch's gradients)."""
        c = self.cfg
        with torch.no_grad():
            obs_n = self.normalize(obs)
            old_lp = self.log_prob(self.policy_mean(obs_n), self.log_std(), action)
            values = self.value(obs_n)
            stats = self._merged_stats(obs)
            bootstrap = self.value(self.normalize(final_obs, stats))
            values_tp1 = torch.cat([values[1:], bootstrap[None]], dim=0)
            deltas = reward * c["reward_scale"] + c["gamma"] * (1.0 - done) * values_tp1 - values
            adv = torch.empty_like(deltas)
            carry = torch.zeros_like(bootstrap)
            for t in range(deltas.shape[0] - 1, -1, -1):
                carry = deltas[t] + c["gamma"] * c["gae_lambda"] * (1.0 - done[t]) * carry
                adv[t] = carry
            ret = adv + values
        flat_obs, flat_act = obs.flatten(0, 1), action.flatten(0, 1)
        flat_lp, adv_f, ret_f = old_lp.reshape(-1), adv.reshape(-1), ret.reshape(-1)
        n = adv_f.shape[0]
        mb = n // c["num_minibatches"]
        perms = perms[:, :c["num_minibatches"] * mb].reshape(-1, mb)
        totals, grads = [], None
        for j in range(perms.shape[0]):
            idx = perms[j]
            for p in self.params.values():
                p.requires_grad_(True)
            o = self.normalize(flat_obs[idx], stats)
            mean, log_std = self.policy_mean(o), self.log_std().expand(len(idx), -1)
            lp = self.log_prob(mean, log_std, flat_act[idx])
            ratio = torch.exp(lp - flat_lp[idx])
            a = adv_f[idx]
            a = (a - torch.mean(a)) / (torch.std(a, correction=0) + 1e-8)
            eps = c["clip_epsilon"]
            policy_loss = -torch.mean(torch.minimum(ratio * a, torch.clamp(ratio, 1 - eps, 1 + eps) * a))
            value_loss = torch.mean((self.value(o) - ret_f[idx]) ** 2)
            ent = torch.mean(torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1))
            total = policy_loss + c["value_cost"] * value_loss - c["entropy_cost"] * ent
            names = list(self.params)
            g = torch.autograd.grad(total, [self.params[k] for k in names])
            for p in self.params.values():
                p.requires_grad_(False)
            step_grads = dict(zip(names, g))
            grads = grads or step_grads
            self._adam(step_grads)
            totals.append(total.detach())
        self.stats = stats
        return {"loss": torch.mean(torch.stack(totals))}, grads
