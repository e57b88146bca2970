#!/usr/bin/env python3
"""The policy-step kernel against its plain version at a switch of the
dynamics (ROADMAP C, open check 4).

    python scripts/kernel_switch_check.py

Trains walk's run config for 40 iterations from seed 0 on the card, as
chip_smoke.py phase 5 does, but with PPO's loss written as the data-parallel
path writes it at one rank (``ppo.shard_loss_fn``: each mean a sum over
the minibatch size, the advantage moments as ``ppo._shard_minibatches``
forms them). Only rounding differs from ``ppo.learn``; the run ends in
other states. On the rollout's final states it holds the kernel against
its plain version over 2 policy steps (phase 5's train-shape check), and
on the envs where they part most: the kernel, the plain version and the
engine (``backend="xla"``) from that env alone, and the plain version and
the kernel from 8 random 1e-6 perturbations of its joint positions. Where
the plain version itself moves as far under those perturbations as the
kernel stands from it, and the kernel agrees with it on every perturbed
input, the env sits on a switch of the dynamics (a contact or limit that
turns on within float32 rounding), not on a kernel fault. Needs one card.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from pbrl_tpu_torch.envs import EnvConfig, MimicVecEnv  # noqa: E402
from pbrl_tpu_torch.envs import humanoid_task as task  # noqa: E402
from pbrl_tpu_torch.mocap import load_clip  # noqa: E402
from pbrl_tpu_torch.model import humanoid_model  # noqa: E402
from pbrl_tpu_torch.ops import field_physics as fp  # noqa: E402
from pbrl_tpu_torch.ops import mimic_kernel  # noqa: E402
from pbrl_tpu_torch.train import checkpoint, ppo, running_stats  # noqa: E402
from pbrl_tpu_torch.utils.configio import dict_to_config  # noqa: E402

ITERS = 40
PERTURB = 1e-6


def sums_learn(config, ts, env_state, traj, perms=None):
    """``ppo.learn`` with the loss of the data-parallel path at one rank."""
    obs_stats = (running_stats.update(ts.obs_stats, traj.obs)
                 if config.normalize_obs else ts.obs_stats)
    with torch.no_grad():
        bootstrap = ts.value(ppo._norm_obs(config, obs_stats, env_state.obs))
    adv, ret = ppo.compute_gae(traj.reward, traj.done, traj.value, bootstrap,
                               config.gamma, config.gae_lambda)
    flat = ppo.Transition(**{f.name: getattr(traj, f.name).flatten(0, 1)
                             for f in dataclasses.fields(ppo.Transition)})
    adv_f, ret_f = adv.reshape(-1), ret.reshape(-1)
    n = adv_f.shape[0]
    mb = n // config.num_minibatches
    perms = torch.stack([torch.randperm(n, generator=ts.generator, device=adv_f.device)
                         for _ in range(config.update_epochs)])
    perms = perms[:, :config.num_minibatches * mb].reshape(-1, mb)
    entries, adv_mean, adv_std = ppo._shard_minibatches(ts.mesh, perms, traj.reward.shape[1],
                                                        adv_f)
    params = ts.params()
    for j, idx in enumerate(entries):
        batch = ppo.Transition(**{f.name: getattr(flat, f.name)[idx]
                                  for f in dataclasses.fields(ppo.Transition)})
        for p in params.values():
            p.grad = None
        total, _, _ = ppo.shard_loss_fn(ts.policy, ts.value, config, batch, adv_f[idx],
                                        ret_f[idx], obs_stats, adv_mean[j], adv_std[j], mb,
                                        with_entropy=True)
        total.backward()
        ts.opt.step(params)
    ts.obs_stats, ts.env_state = obs_stats, env_state
    ts.env_steps += config.steps_per_iteration
    return {"reward_mean": torch.mean(traj.reward)}


def two_steps(step, q, v, u):
    out = (q, v)
    for _ in range(2):
        out = step(out[0], out[1], u)
    return out


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    smoke.log("device", smi)
    model, clip = humanoid_model(), load_clip("walk", device=dev)
    _, _, run = checkpoint.load_policy(checkpoint.bundled_policy("walk"), device=dev)
    env_cfg = dict_to_config(EnvConfig, run["env_config"])
    walk_cfg = dict_to_config(ppo.TrainConfig, run["train_config"])
    cfg = dataclasses.replace(walk_cfg, total_env_steps=ITERS * walk_cfg.steps_per_iteration)
    env = MimicVecEnv(model, clip, env_cfg, device=dev)
    t = time.perf_counter()
    ppo.learn = sums_learn
    ts, history = ppo.train(env, cfg, device=dev)
    smoke.log("train", f"{ITERS} iterations with the summed loss in {time.perf_counter() - t:.1f}s, "
              f"reward_mean {history[0]['reward_mean']:.4f} -> {history[-1]['reward_mean']:.4f}")
    st = ts.env_state
    with torch.no_grad():
        mean, _ = ts.policy(running_stats.normalize(ts.obs_stats, st.obs))
        u = task.pd_target(env.clip, env.config, st.time, mean, env.tables).contiguous()
    ks, sp = env._kstep, env._kspec
    plain = lambda a, b, c: mimic_kernel.mimic_step_plain(sp, a, b, c)
    smoke.log("train-shape", smoke.fmt(smoke.compare(ks, plain, st.qpos, st.qvel, u, steps=2)))
    k2, p2 = two_steps(ks, st.qpos, st.qvel, u), two_steps(plain, st.qpos, st.qvel, u)
    err = torch.maximum((k2[2] - p2[2]).abs().amax(dim=(1, 2)), (k2[0] - p2[0]).abs().amax(dim=1))
    worst = torch.argsort(err, descending=True)[:2].tolist()
    smoke.log("worst envs", " ".join(f"{e}: {float(err[e]):.3e}" for e in worst))
    xenv = MimicVecEnv(model, clip, env_cfg, backend="xla", device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    for e in worst:
        q, v, ue = (x[e:e + 1].contiguous() for x in (st.qpos, st.qvel, u))
        kb, pb = two_steps(ks, q, v, ue), two_steps(plain, q, v, ue)
        xq, xv = q, v
        for _ in range(2):
            xq, xv = xenv._physics(xq, xv, ue)[:2]
        spread = []
        for _ in range(8):
            d = PERTURB * torch.randn(q.shape, generator=gen, device=dev)
            d[:, 3:7] = 0.0  # the root quaternion stays a unit quaternion
            pp, kp = two_steps(plain, (q + d).contiguous(), v, ue), two_steps(
                ks, (q + d).contiguous(), v, ue)
            spread.append((float((pp[0] - pb[0]).abs().max()),
                           float((kp[0] - pp[0]).abs().max())))
        s = np.array(spread)
        smoke.log(f"env {e}", f"{int(fp.contacts_touching(sp, q).sum())} contacts touching; "
                  f"qpos after 2 steps: kernel-plain {float((kb[0] - pb[0]).abs().max()):.3e}, "
                  f"engine-plain {float((xq - pb[0]).abs().max()):.3e}, engine-kernel "
                  f"{float((xq - kb[0]).abs().max()):.3e}; under {PERTURB:g} perturbations: "
                  f"plain moves {s[:, 0].min():.3e}-{s[:, 0].max():.3e}, kernel-plain "
                  f"{s[:, 1].max():.3e} at most | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
