"""Checkpoints of the port, and weights carried across from pbrl_tpu
(counterpart of ``pbrl_tpu/train/checkpoint.py``).

The port's checkpoints are ``checkpoint_<step>.pt`` files in a run
directory, each a ``torch.save`` of the learner state: the policy and
value state dicts, the optimiser state (count, mu, nu), the observation
statistics and ``env_steps``. The last 3 are kept (pbrl_tpu's
``max_to_keep=3``); env states are not saved (episodes restart on resume).
``run_config.json`` beside them has pbrl_tpu's schema, so either package's
``eval`` can rebuild the training env.

pbrl_tpu keeps its checkpoints as Orbax stores, which only ``orbax`` can
read. ``scripts/export_torch_policy.py`` restores one with the JAX stack
and writes what the port needs into ``.npz`` files read here with numpy:

* ``<clip>_policy.npz``: the policy params in float32 under flax's names
  (``torso/hidden_0/kernel`` ...), the clamped ``log_std``, the
  observation statistics and the run configuration;
* ``<clip>_train_state.npz``: the rest of the learner state, for a
  fine-tune that resumes as pbrl_tpu's would: the value params, the
  unclamped ``log_std``, Adam's count, mu and nu of both nets (under
  ``opt/mu/policy/...``), the obs stats, ``env_steps`` and the step.

A flax ``Dense`` kernel of shape (in, out) becomes ``Linear.weight`` of
shape (out, in).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Mapping, Optional

import numpy as np
import torch

from pbrl_tpu_torch.train.networks import PolicyNetwork
from pbrl_tpu_torch.train.running_stats import RunningStats
from pbrl_tpu_torch.utils.configio import config_to_dict

BUNDLED_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "assets")
_RUN_CONFIG = "run_config.json"
_CKPT = re.compile(r"checkpoint_(\d+)\.pt$")
MAX_TO_KEEP = 3


# ---------------------------------------------------------------------------
# flax params <-> state dicts
# ---------------------------------------------------------------------------


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def flax_state_dict(params: Mapping) -> dict:
    """pbrl_tpu params of one network (flax tree or its '/'-flattened form,
    numpy leaves; an outer ``params`` level is accepted) -> the port
    module's ``state_dict``."""
    flat = _flatten(params) if any(isinstance(v, Mapping) for v in params.values()) \
        else {k: np.asarray(v) for k, v in params.items()}
    flat = {k.removeprefix("params/"): v for k, v in flat.items()}
    sd = {}
    for k, v in flat.items():
        parts = k.split("/")
        if parts[-1] == "kernel":
            sd[".".join(parts[:-1]) + ".weight"] = torch.from_numpy(
                np.array(v.T, np.float32, order="C"))
        else:
            sd[".".join(parts)] = torch.from_numpy(np.array(v, np.float32))
    return sd


def policy_from_params(params: Mapping, hidden=(1024, 512)) -> PolicyNetwork:
    sd = flax_state_dict(params)
    obs_size = sd["torso.hidden_0.weight"].shape[1]
    net = PolicyNetwork(obs_size, sd["log_std"].shape[0], hidden=tuple(hidden))
    net.load_state_dict(sd)
    return net


# ---------------------------------------------------------------------------
# Run configuration
# ---------------------------------------------------------------------------


def save_run_config(directory: str, env, train_config) -> None:
    """Write the run's clip, env config and train config as pbrl_tpu does."""
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    meta = {
        "clip": getattr(getattr(env, "clip", None), "name", None),
        "env_config": config_to_dict(env.config) if getattr(env, "config", None) else None,
        "train_config": config_to_dict(train_config),
    }
    with open(os.path.join(directory, _RUN_CONFIG), "w") as f:
        json.dump(meta, f, indent=2)


def load_run_config(directory: str) -> dict:
    path = os.path.join(directory, _RUN_CONFIG)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {_RUN_CONFIG} in {directory}")
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# The port's checkpoints
# ---------------------------------------------------------------------------


def _steps(directory: str) -> list:
    found = (_CKPT.search(os.path.basename(p))
             for p in glob.glob(os.path.join(directory, "checkpoint_*.pt")))
    return sorted(int(m.group(1)) for m in found if m)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"checkpoint_{int(step)}.pt")


def _write(directory: str, payload: dict, step: int) -> None:
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)  # a cut-off save leaves no checkpoint behind
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.unlink(_path(directory, old))


def save(directory: str, ts, step: int) -> None:
    """Persist the learner slice of a ``ppo.TrainState`` (PPO's, or APG's,
    whose optimiser covers the policy only)."""
    cpu = lambda sd: {k: v.detach().cpu() for k, v in sd.items()}
    _write(directory, {
        "policy": cpu(ts.policy.state_dict()),
        "value": cpu(ts.value.state_dict()),
        "opt": ts.opt.state_dict(),
        "obs_stats": {k: getattr(ts.obs_stats, k).detach().cpu()
                      for k in ("count", "mean", "m2")},
        "env_steps": int(ts.env_steps),
    }, step)


def restore(directory: str, step: Optional[int] = None, device="cpu") -> dict:
    """The payload of the latest (or given) checkpoint, tensors on ``device``."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return torch.load(_path(directory, step), map_location=device, weights_only=True)


def restore_params_into(ts, payload: dict) -> None:
    """Load a PPO or APG payload's params, obs stats and ``env_steps`` into
    a ``ppo.TrainState`` in place and leave its optimiser as it is: APG's
    warm start and resume restart the optimiser, as pbrl_tpu's do."""
    ts.policy.load_state_dict(payload["policy"])
    ts.value.load_state_dict(payload["value"])
    dev = ts.policy.log_std.device
    ts.obs_stats = RunningStats(**{k: payload["obs_stats"][k].to(dev)
                                   for k in ("count", "mean", "m2")})
    ts.env_steps = int(payload["env_steps"])


def restore_into(ts, payload: dict) -> None:
    """Load a checkpoint payload into a ``ppo.TrainState`` in place."""
    restore_params_into(ts, payload)
    ts.opt.load_state_dict(payload["opt"], ts.policy.log_std.device)


# ---------------------------------------------------------------------------
# Exported pbrl_tpu checkpoints
# ---------------------------------------------------------------------------


def bundled_policy(clip: str) -> str:
    return os.path.join(BUNDLED_DIR, f"{clip}_policy.npz")


def bundled_train_state(clip: str) -> str:
    return os.path.join(BUNDLED_DIR, f"{clip}_train_state.npz")


def _read_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _stats(arrays: dict) -> RunningStats:
    return RunningStats(**{k: torch.from_numpy(np.asarray(arrays[f"obs_stats/{k}"], np.float32))
                           for k in ("count", "mean", "m2")})


def load_policy(path: str, device="cuda"):
    """(PolicyNetwork, RunningStats, run config dict) from an exported .npz."""
    arrays = _read_npz(path)
    run = json.loads(str(arrays.pop("run_config")))
    hidden = tuple((run.get("train_config") or {}).get("hidden", (1024, 512)))
    policy = {k.removeprefix("policy/"): v for k, v in arrays.items()
              if k.startswith("policy/")}
    net = policy_from_params(policy, hidden=hidden).to(device).eval()
    return net, _stats(arrays).to(device), run


def load_policy_from_dir(directory: str, device="cuda"):
    """(PolicyNetwork, RunningStats) from the port's latest checkpoint in a
    run directory (its ``run_config.json`` gives the widths)."""
    run = load_run_config(directory)
    payload = restore(directory, device="cpu")
    sd = payload["policy"]
    hidden = tuple((run.get("train_config") or {}).get("hidden", (1024, 512)))
    net = PolicyNetwork(sd["torso.hidden_0.weight"].shape[1], sd["log_std"].shape[0],
                        hidden=hidden)
    net.load_state_dict(sd)
    stats = RunningStats(**{k: payload["obs_stats"][k] for k in ("count", "mean", "m2")})
    return net.to(device).eval(), stats.to(device)


def _unwrapped_env_steps(arrays: dict, run: dict) -> int:
    """pbrl_tpu counts env steps in int32, which wraps past 2**31
    (``ckpts/backflip`` holds -1,992,425,472). Adam's count gives the
    iterations run, hence the count modulo 2**32 picks the true value."""
    raw = int(arrays["env_steps"])
    cfg = run["train_config"]
    per_iteration = cfg["num_envs"] * cfg["unroll_length"]
    updates = cfg["update_epochs"] * cfg["num_minibatches"]
    steps = int(arrays["opt/count"]) // updates * per_iteration
    if (steps - raw) % 2 ** 32:
        raise ValueError(f"env_steps {raw} is not {steps} modulo 2**32")
    return steps


def import_train_state(directory: str, train_state: str, policy: str) -> int:
    """Write an exported pbrl_tpu learner state (``<clip>_train_state.npz``
    plus the policy params of ``<clip>_policy.npz``) into ``directory`` as
    the port's checkpoint at pbrl_tpu's step, with its ``run_config.json``;
    returns the step. A ``ppo.train`` on that directory then resumes as
    pbrl_tpu's resume from the Orbax checkpoint would."""
    arrays = _read_npz(train_state)
    pol = {k.removeprefix("policy/"): v for k, v in _read_npz(policy).items()
           if k.startswith("policy/")}
    pol["log_std"] = arrays["policy/log_std"]  # the unclamped param, not the clamped copy

    def tree(prefix):
        return flax_state_dict({k.removeprefix(prefix): v for k, v in arrays.items()
                                if k.startswith(prefix)})

    def moments(which):
        out = {f"policy/{k}": v for k, v in tree(f"opt/{which}/policy/").items()}
        out.update({f"value/{k}": v for k, v in tree(f"opt/{which}/value/").items()})
        return out

    step = int(arrays["step"])
    run = json.loads(str(arrays["run_config"]))
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, _RUN_CONFIG), "w") as f:
        f.write(str(arrays["run_config"]))
    stats = _stats(arrays)
    _write(directory, {
        "policy": flax_state_dict(pol),
        "value": tree("value/"),
        "opt": {"count": int(arrays["opt/count"]), "mu": moments("mu"), "nu": moments("nu")},
        "obs_stats": {k: getattr(stats, k) for k in ("count", "mean", "m2")},
        "env_steps": _unwrapped_env_steps(arrays, run),
    }, step)
    return step
