"""The APG cell's reference on the CPU: its followed window in worker
processes gives the sequential window's loss and gradient, and its TF32
stand-in rounds as the card's TF32 matmuls round their operands."""

import json
import os

import torch

from benchmark.reference import apg as ref_apg
from benchmark.reference.env import RefEnv
from conftest import ROOT


def test_workers_give_the_sequential_window():
    with open(os.path.join(ROOT, "benchmark", "configs", "backflip-apg.json")) as f:
        conf = json.load(f)
    ec = dict(conf["env_config"], policy_dt=0.004)
    B, H = 3, 3
    cfg = dict(conf["apg_config"], num_envs=B, horizon=H)
    env = RefEnv("backflip", ec, "cpu")
    g = torch.Generator().manual_seed(11)
    widths = [env.obs(*env.start(torch.zeros(1)), torch.zeros(1)).shape[1], 32, 28]
    value_widths = widths[:2] + [1]

    def net(prefix, w):
        return {**{f"{prefix}/torso.hidden_0.{k}": 0.3 * torch.randn(s, generator=g)
                   for k, s in (("weight", (w[1], w[0])), ("bias", (w[1],)))},
                **{f"{prefix}/torso.out.{k}": 0.3 * torch.randn(s, generator=g)
                   for k, s in (("weight", (w[2], w[1])), ("bias", (w[2],)))}}

    params, value = net("policy", widths), net("value", value_widths)
    stats = [torch.tensor(100.0), torch.zeros(widths[0]), 100.0 * torch.ones(widths[0])]
    t0 = torch.tensor([0.1, 0.4, 0.7])
    q, v = env.start(t0)
    entry = {"qpos": q, "qvel": v, "time": t0, "episode_start": t0}
    noise = torch.randn((H, B, 28), generator=g)
    # a path near the reference's own: its steps with the action's noise doubled
    path, t = [], t0
    with torch.no_grad():
        for k in range(H):
            a = ref_apg.action(params, stats, env.obs(q, v, t), 2 * noise[k], cfg)
            out = env.step(q, v, t, t0, a)
            q, v, t = out["qpos"], out["qvel"], t + env.n_substeps * ec["physics_dt"]
            path.append((q, v))
    loss, grads = ref_apg.loss_and_grad(env, params, value, stats, entry, noise, cfg, path)
    windows = ref_apg.FollowedWindows("backflip", ec, cfg, workers=2)
    try:
        loss_w, grads_w = windows(params, value, stats, entry, noise, path)
    finally:
        windows.close()
    assert abs(loss_w - loss) <= 1e-6 * abs(loss)
    num = sum(float(torch.sum((grads_w[k] - grads[k]) ** 2)) for k in grads)
    den = sum(float(torch.sum(grads[k] ** 2)) for k in grads)
    assert den > 0 and (num / den) ** 0.5 <= 1e-5


def test_tf32_stand_in_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -3.0000002, 1e-30])
    r = ref_apg.tf32(x)
    assert torch.equal(r.view(torch.int32) & 0x1FFF, torch.zeros(4, dtype=torch.int32))
    assert r[0] == 1.0 + 2 ** -10 and r[1] == 1.0 + 2 ** -10  # to nearest, ties away
    assert r[2] == -3.0
    assert torch.all(torch.abs(r - x) <= torch.abs(x) * 2 ** -11)
