"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py).

    python tests/torch_dp_worker.py JOB RANK WORLD PORT INPUTS.npz OUT_DIR

Joins a gloo process group on the CPU at ``localhost:PORT`` through
``pbrl_tpu_torch.parallel``, runs JOB on this rank's share of the inputs
and writes ``OUT_DIR/rank<RANK>.npz``. Imports torch and the port only.
Jobs:

* ``stats``: ``running_stats.update`` of this rank's rows of ``batch``;
* ``ppo``: PPO iterations on the sharded toy env from the given params,
  with the given action noise and permutations (one set per iteration);
* ``apg``: APG iterations on the sharded driven toy env, likewise;
* ``curriculum``: ``MimicVecEnv.auto_reset`` with the curriculum on a
  humanoid batch, from the given states and draws.
"""

import json
import sys

import numpy as np
import torch

from pbrl_tpu_torch.envs import VecState
from pbrl_tpu_torch.parallel import DistributedConfig, initialize_distributed, make_mesh
from pbrl_tpu_torch.parallel import distributed
from pbrl_tpu_torch.train import apg, networks, optim, ppo, running_stats

OBS = 3


class ShardToyEnv:
    """tests/test_torch_ppo.py's ToyEnv (the twin of its JToyEnv) holding
    this rank's rows of the batch: obs and episode ends by the global env
    index."""

    is_vectorized = True
    observation_size = OBS
    action_size = OBS

    def __init__(self, mesh):
        self.mesh = mesh

    def _index(self, n):
        return torch.arange(n) + self.mesh.rank * n

    def _obs(self, t):
        i = self._index(t.shape[0]).to(torch.float32)[:, None]
        k = torch.arange(OBS, dtype=torch.float32)[None]
        return torch.sin(1.3 * t[:, None] + 0.7 * i + 2.1 * k)

    def reset(self, num_envs, generator=None, t0=None):
        z = torch.zeros(self.mesh.local(num_envs))
        return VecState(qpos=z[:, None], qvel=z[:, None], time=z, episode_start=z,
                        obs=self._obs(z), reward=z, done=z, metrics={"pose_error": z})

    def step(self, s, action):
        reward = torch.exp(-torch.sum((action - s.obs) ** 2, dim=-1))
        t = s.time + 1
        done = (t >= 5 + self._index(t.shape[0]) % 3).to(torch.float32)
        return s.replace(obs=self._obs(t), time=t, reward=reward, done=done,
                         metrics={"pose_error": 0.5 * reward})

    def auto_reset(self, s, generator=None):
        fresh = self.reset(s.done.shape[0] * self.mesh.world)
        d = s.done > 0
        return s.replace(obs=torch.where(d[:, None], fresh.obs, s.obs),
                         time=torch.where(d, fresh.time, s.time))


class ShardDrivenEnv(ShardToyEnv):
    """tests/test_torch_apg.py's DrivenEnv: the next obs depends on the action."""

    def step(self, s, action):
        out = super().step(s, action)
        return out.replace(obs=out.obs + 0.5 * torch.tanh(action))


def _nets(inputs, cfg, frozen_value):
    policy = networks.PolicyNetwork(OBS, OBS, cfg.hidden, fixed_log_std=cfg.fixed_log_std)
    value = networks.ValueNetwork(OBS, cfg.hidden)
    for name, net in (("policy", policy), ("value", value)):
        net.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(v) for k, v in inputs.items()
                             if k.startswith(name + ".")})
    if frozen_value:
        value.requires_grad_(False)
    return policy, value


def _state(ts, out, i):
    """Copies: the params are updated in place by the next iteration."""
    for name, net in (("policy", ts.policy), ("value", ts.value)):
        for k, v in net.state_dict().items():
            out[f"it{i}/{name}.{k}"] = v.numpy().copy()
    for k in ("count", "mean", "m2"):
        out[f"it{i}/stats.{k}"] = getattr(ts.obs_stats, k).numpy().copy()
    out[f"it{i}/obs"] = ts.env_state.obs.numpy().copy()
    out[f"it{i}/time"] = ts.env_state.time.numpy().copy()


def run(job, mesh, inputs, meta):
    out = {}
    if job == "stats":
        stats = running_stats.init(inputs["batch"].shape[-1], "cpu")
        batch = mesh.rows(torch.from_numpy(inputs["batch"]))
        stats = running_stats.update(stats, batch, mesh.group)
        return {k: getattr(stats, k).numpy() for k in ("count", "mean", "m2")}
    if job in ("ppo", "apg"):
        if job == "ppo":
            cfg = ppo.TrainConfig(**{**meta["config"], "hidden": tuple(meta["config"]["hidden"])})
            env = ShardToyEnv(mesh)
            opt = optim.Adam(cfg.learning_rate, cfg.max_grad_norm, cfg.total_updates)
        else:
            cfg = apg.APGConfig(**{**meta["config"], "hidden": tuple(meta["config"]["hidden"])})
            env = ShardDrivenEnv(mesh)
            opt = apg.make_optimizer(cfg)
        policy, value = _nets(inputs, cfg, frozen_value=job == "apg")
        ts = ppo.TrainState(policy=policy, value=value, opt=opt,
                            obs_stats=running_stats.init(OBS, "cpu"),
                            env_state=env.reset(cfg.num_envs), generator=torch.Generator(),
                            env_steps=0, mesh=mesh)
        for i in range(meta["iterations"]):
            noise = torch.from_numpy(inputs[f"noise{i}"])
            if job == "ppo":
                ts, metrics = ppo.train_step(env, cfg, ts, noise=noise,
                                             perms=torch.from_numpy(inputs[f"perms{i}"]))
            else:
                ts, metrics = apg.train_step(env, cfg, ts, noise=noise)
            out.update({f"it{i}/metric.{k}": np.asarray(float(v)) for k, v in metrics.items()})
            _state(ts, out, i)
        out["env_steps"] = np.asarray(ts.env_steps)
        out["opt_count"] = np.asarray(ts.opt.count)
        return out
    if job == "curriculum":
        from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv
        from pbrl_tpu_torch.mocap import load_clip
        from pbrl_tpu_torch.model import humanoid_model

        env = MimicVecEnv(humanoid_model(), load_clip("walk", device="cpu"),
                          EnvConfig(**meta["env_config"]), device="cpu", mesh=mesh)
        fields = ("qpos", "qvel", "time", "episode_start", "obs", "reward", "done")
        state = VecState(**{k: mesh.rows(torch.from_numpy(inputs[k])) for k in fields},
                         metrics={})
        got = env.auto_reset(state, t0=torch.from_numpy(inputs["t0"]),
                             u=torch.from_numpy(inputs["u"]),
                             peer=torch.from_numpy(inputs["peer"]))
        return {k: getattr(got, k).numpy() for k in fields}
    raise ValueError(job)


def main(job, rank, world, port, inputs_path, out_dir):
    initialize_distributed(DistributedConfig(f"localhost:{port}", int(world), int(rank)),
                           device="cpu")
    try:
        mesh = make_mesh("cpu")
        assert (mesh.world, mesh.rank) == (int(world), int(rank))
        assert distributed.backend() == "gloo"
        with np.load(inputs_path) as z:
            inputs = {k: z[k] for k in z.files}
        meta = json.loads(str(inputs.pop("meta")))
        out = run(job, mesh, inputs, meta)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(*sys.argv[1:])
