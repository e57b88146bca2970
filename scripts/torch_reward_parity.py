"""Imitation-reward parity of the PyTorch port: the same trained policy
through the port's engine and through CPU MuJoCo ``mj_step``.

The counterpart of ``scripts/reward_parity.py`` (which drives pbrl_tpu's
engine), with the same protocol and row fields:

  ours:   the port's ``MimicVecEnv(backend="xla", device="cpu")``, the
          einsum engine (``chip_smoke.py`` holds it against the kernel on
          the card)
  oracle: ``mujoco.mj_step`` over ``pbrl_tpu_torch.model.mjcf.to_mjcf(
          humanoid_spec())``, the same Stable-PD law evaluated from
          MuJoCo's live mass matrix (``mj_fullM``) and bias forces every
          substep, MuJoCo's (qpos, qvel, xpos, xquat) scored by the port's
          own ``_obs`` and reward functions

Both rollouts start at the clip start with the deterministic policy mean,
at the clip's eval-stripped run config (as ``cli eval`` strips it) with no
reference-state init. With ``--rollouts`` > 1 (by default 4 for the
chaotic clips backflip, kick and punch, as PARITY.md's rows) both sides
start from the same fan of +-k mrad perturbations of the first actuated
joint, and the gap is taken between the per-side means. Policies: each
clip's bundled export (``pbrl_tpu_torch/assets/<clip>_policy.npz``) with
its run config, or ``--checkpoint-dir`` (a run directory of the port, or
one with an exported policy and its ``run_config.json``).

CPU only (MuJoCo is a host library). Writes PARITY_TORCH.md (never
PARITY.md) with each row beside PARITY.md's, and prints one JSON line per
clip:

  python scripts/torch_reward_parity.py                       # all seven clips
  python scripts/torch_reward_parity.py --clip walk --steps 90

It exits 1 when walk's or backflip's full-window gap is 10% or more (the
north-star clause), as ``scripts/reward_parity.py`` exits 1 on its worst
row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CLIPS = ("walk", "backflip", "getup_facedown", "getup_faceup", "jump", "kick", "punch")
CHAOTIC = ("backflip", "kick", "punch")  # PARITY.md's 4-rollout protocol
CRITERION = ("walk", "backflip")         # the north-star clause: gap < 10%


def parity_env(env):
    """The env of the parity protocol: the port's engine on the CPU, from
    the clip start (no reference-state init, no curriculum)."""
    from pbrl_tpu_torch.envs import MimicVecEnv
    from pbrl_tpu_torch.model import humanoid_model

    cfg = dataclasses.replace(env.config, reference_state_init=False,
                              curriculum_reset_prob=0.0)
    return MimicVecEnv(humanoid_model(), env.clip, cfg, backend="xla", device="cpu")


def _mean_action(policy, stats, obs):
    import torch

    from pbrl_tpu_torch.train.running_stats import normalize

    with torch.no_grad():
        mean, _ = policy(normalize(stats, obs))
    return mean


def mujoco_rollout(env, policy, stats, steps: int, perturb: float = 0.0):
    """The deterministic policy through CPU MuJoCo dynamics: (rewards (T,),
    qpos (T, nq)), scored by ``env``'s own reward over MuJoCo's state."""
    import mujoco
    import torch

    from pbrl_tpu_torch.envs import humanoid_task as task
    from pbrl_tpu_torch.mocap.clip import reference_state
    from pbrl_tpu_torch.model import humanoid_spec, to_mjcf

    m, cfg = env.model, env.config
    mj = mujoco.MjModel.from_xml_string(to_mjcf(humanoid_spec()))
    mj.opt.timestep = float(cfg.physics_dt)
    if not cfg.enforce_joint_limits:
        # as the env: the ballistic clips train with hinge limits off
        mj.jnt_limited[:] = 0
    data = mujoco.MjData(mj)
    assert mj.nq == m.nq and mj.nv == m.nv and mj.nu == m.nu
    for b, name in enumerate(m.body_names):  # our body b is MuJoCo's b + 1
        assert mj.body(b + 1).name == name, (b, name, mj.body(b + 1).name)

    dofadr = np.asarray(m.actuator_dofadr)
    qposadr = np.asarray(m.actuator_qposadr)
    kp = np.asarray(env.tables.gains.kp.cpu(), np.float64)
    kd = np.asarray(env.tables.gains.kd.cpu(), np.float64)
    gear = np.asarray(m.actuator_gear, np.float64)
    cr = np.asarray(m.actuator_ctrlrange, np.float64)
    tau_lo = gear * cr[:, 0] * cfg.torque_limit_scale
    tau_hi = gear * cr[:, 1] * cfg.torque_limit_scale
    lo = np.asarray(m.jnt_range)[1:, 0]
    hi = np.asarray(m.jnt_range)[1:, 1]
    kp_full, kd_full = np.zeros(m.nv), np.zeros(m.nv)
    kp_full[dofadr], kd_full[dofadr] = kp, kd
    dt = float(cfg.physics_dt)

    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32)[None]
    q0, v0 = reference_state(env.clip, torch.zeros(1))
    data.qpos[:] = q0[0].double().numpy()
    data.qpos[7] += perturb
    data.qvel[:] = v0[0].double().numpy()
    mujoco.mj_forward(mj, data)

    def stable_pd_torque(target):
        M = np.zeros((m.nv, m.nv))
        mujoco.mj_fullM(mj, data, M)  # the live mass matrix
        e_full = np.zeros(m.nv)
        e_full[dofadr] = (data.qpos[qposadr] + dt * data.qvel[dofadr]) - target
        rhs = -np.asarray(data.qfrc_bias) - kp_full * e_full - kd_full * data.qvel
        qacc = np.linalg.solve(M + dt * np.diag(kd_full), rhs)
        tau = -kp * e_full[dofadr] - kd * (data.qvel[dofadr] + dt * qacc[dofadr])
        return np.clip(tau, tau_lo, tau_hi)

    rewards, qpos_hist = [], []
    t = 0.0
    for _ in range(steps):
        tt = f32([t])[0]
        obs = task.observation(m, env.clip, cfg, f32(data.qpos), f32(data.qvel), tt,
                               reference_state(env.clip, tt)[0])
        action = _mean_action(policy, stats, obs)[0].double().numpy()
        if cfg.action_mode == "residual":
            q_ref, _ = reference_state(env.clip, f32([t + cfg.policy_dt + cfg.ref_target_lead])[0])
            action = q_ref[0].double().numpy()[qposadr] + action
        target = np.clip(action, lo, hi) if cfg.enforce_joint_limits else action
        for _ in range(cfg.n_substeps):
            tau = stable_pd_torque(target)
            data.qfrc_applied[:] = 0.0
            data.qfrc_applied[dofadr] = tau
            mujoco.mj_step(mj, data)
        t += cfg.n_substeps * dt
        with torch.no_grad():
            tt = f32([t])[0]
            r, _ = task.reward(m, env.clip, cfg, f32(data.qpos), f32(data.qvel), tt,
                               reference_state(env.clip, tt), f32(data.xpos[1:]),
                               f32(data.xquat[1:]), torch.zeros(1))
        rewards.append(float(r[0]))
        qpos_hist.append(np.asarray(data.qpos).copy())
    return np.asarray(rewards), np.asarray(qpos_hist)


def our_rollout(env, policy, stats, steps: int, perturb: float = 0.0):
    """The deterministic policy through the port's engine from the clip
    start (the same start perturbation as :func:`mujoco_rollout`)."""
    import torch

    from pbrl_tpu_torch.envs import humanoid_task as task
    from pbrl_tpu_torch.mocap.clip import reference_state

    s = env.reset(1)
    if perturb:
        qpos = s.qpos.clone()
        qpos[:, 7] += perturb
        obs = task.observation(env.model, env.clip, env.config, qpos, s.qvel, s.time,
                               reference_state(env.clip, s.time)[0])
        s = s.replace(qpos=qpos, obs=obs)
    rew, qpos = [], []
    with torch.no_grad():
        for _ in range(steps):
            s = env.step(s, _mean_action(policy, stats, s.obs))
            rew.append(float(s.reward[0]))
            qpos.append(s.qpos[0].double().numpy())
    return np.asarray(rew), np.asarray(qpos)


def fan(rollouts: int):
    """The start perturbations: 0, then a symmetric +-k mrad fan."""
    return [0.0] + [0.001 * ((k + 2) // 2) * (1 if k % 2 else -1) for k in range(rollouts - 1)]


def run_one(clip, checkpoint_dir, steps: int, rollouts: int) -> dict:
    """Roll one trained clip through both dynamics; return its parity row
    (reward_parity.py's fields)."""
    from pbrl_tpu_torch.cli import _policy_env

    args = argparse.Namespace(checkpoint_dir=checkpoint_dir, clip=clip, policy=None,
                              device="cpu", env_set=[])
    policy, stats, _, env = _policy_env(args)
    env = parity_env(env)
    ours_runs, mj_runs = [], []
    for p in fan(rollouts):
        o_r, o_q = our_rollout(env, policy, stats, steps, perturb=p)
        m_r, m_q = mujoco_rollout(env, policy, stats, steps, perturb=p)
        ours_runs.append(o_r)
        mj_runs.append(m_r)
        if p == 0.0:
            ours_q, mj_q = o_q, m_q
    ours_r, mj_r = np.mean(ours_runs, axis=0), np.mean(mj_runs, axis=0)
    ours, oracle = float(ours_r.mean()), float(mj_r.mean())
    k = steps // 3
    ours_ss, mj_ss = float(ours_r[k:].mean()), float(mj_r[k:].mean())

    def thirds(r):
        return [round(float(r[i * k:(i + 1) * k].mean()), 4) for i in range(3)]

    return {
        "clip": env.clip.name, "checkpoint": checkpoint_dir or "bundled", "steps": steps,
        "rollouts": rollouts, "reward_ours": round(ours, 4), "reward_mujoco": round(oracle, 4),
        "relative_gap": round(abs(ours - oracle) / max(oracle, 1e-9), 4),
        "steady_state_gap": round(abs(ours_ss - mj_ss) / max(mj_ss, 1e-9), 4),
        "root_pos_rmse_m": round(float(np.sqrt(((ours_q[:, :3] - mj_q[:, :3]) ** 2).mean())), 4),
        "ours_by_third": thirds(ours_r), "mujoco_by_third": thirds(mj_r),
        "per_rollout_ours": [round(float(r.mean()), 4) for r in ours_runs],
        "per_rollout_mujoco": [round(float(r.mean()), 4) for r in mj_runs],
    }


def parity_md_rows(path=os.path.join(ROOT, "PARITY.md")) -> dict:
    """PARITY.md's rows (pbrl_tpu's engine): clip -> (ours, MuJoCo, full-
    window gap %, rollouts)."""
    rows = {}
    if not os.path.exists(path):
        return rows
    pat = re.compile(r"^\| \**(\w+)\** \| ([\d.]+) \[.*?\] \| ([\d.]+) \[.*?\] \| \**([\d.]+)%\**"
                     r" \|.*\| (\d+) \|$")
    with open(path) as f:
        for line in f:
            m = pat.match(line.strip())
            if m:
                rows[m.group(1)] = (float(m.group(2)), float(m.group(3)), float(m.group(4)),
                                    int(m.group(5)))
    return rows


def write_table(rows, steps: int, out: str) -> None:
    ref = parity_md_rows()
    lines = []
    for r in rows:
        p = ref.get(r["clip"])
        beside = ("| - | - | - |" if p is None else
                  f"| {p[0]:.4f} / {p[1]:.4f} | {p[2]:.1f}% | {r['reward_ours'] - p[0]:+.4f} |")
        lines.append(
            f"| {r['clip']} | {r['reward_ours']:.4f} {r['ours_by_third']} "
            f"| {r['reward_mujoco']:.4f} {r['mujoco_by_third']} "
            f"| {r['relative_gap'] * 100:.1f}% | {r['steady_state_gap'] * 100:.1f}% "
            f"| {r['root_pos_rmse_m']:.4f} | {r['rollouts']} {beside}")
    crit = [r["relative_gap"] for r in rows if r["clip"] in CRITERION]
    with open(out, "w") as f:
        f.write(f"""# PARITY_TORCH — the PyTorch port's imitation-reward parity vs CPU MuJoCo

Each policy (deterministic mean action) rolled {steps} policy steps from its
clip start through two dynamics: the port's engine
(`MimicVecEnv(backend="xla", device="cpu")`) and CPU MuJoCo `mj_step` over
`pbrl_tpu_torch.model.mjcf.to_mjcf(humanoid_spec())`, with the same
Stable-PD law (MuJoCo's live `mj_fullM` and bias every substep) and the
port's own observation and reward functions, so the only difference
measured is the dynamics. Rollouts > 1: the mean over identically
perturbed starts on both sides (+-k mrad on the first actuated joint).
The last three columns are PARITY.md's row for pbrl_tpu's engine (ours /
MuJoCo, its full-window gap) and the port's "ours" minus pbrl_tpu's.
North-star clause: walk and backflip full-window gap below 10%.

| clip | port: mean [by thirds] | MuJoCo oracle: mean [by thirds] | full-window gap | steady-state gap | root RMSE (m) | rollouts | PARITY.md ours / MuJoCo | PARITY.md gap | port - PARITY.md ours |
|---|---|---|---|---|---|---|---|---|---|
{chr(10).join(lines)}

Worst full-window gap of walk and backflip: **{max(crit) * 100 if crit else float('nan'):.1f}%**
(criterion < 10%).

Made by `python scripts/torch_reward_parity.py` (`scripts/torch_reward_parity.py`).
""")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clip", action="append", default=[],
                    help=f"repeatable; default: all seven ({', '.join(CLIPS)})")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="a run directory for the one --clip (default: the bundled policy)")
    ap.add_argument("--steps", type=int, default=90, help="policy steps (about 3 walk cycles)")
    ap.add_argument("--rollouts", type=int, default=None,
                    help=f"starts per side (default 4 for {', '.join(CHAOTIC)}, else 1)")
    ap.add_argument("--out", default=os.path.join(ROOT, "PARITY_TORCH.md"))
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.join(ROOT, "PARITY.md"):
        raise SystemExit("PARITY.md is pbrl_tpu's record: write the port's elsewhere")
    clips = args.clip or list(CLIPS)
    if args.checkpoint_dir and len(clips) != 1:
        raise SystemExit("--checkpoint-dir takes one --clip")
    rows = []
    for clip in clips:
        n = args.rollouts or (4 if clip in CHAOTIC else 1)
        r = run_one(clip, args.checkpoint_dir, args.steps, n)
        print(json.dumps(r), flush=True)
        rows.append(r)
    write_table(rows, args.steps, args.out)
    print(f"-> {args.out}")
    crit = [r["relative_gap"] for r in rows if r["clip"] in CRITERION]
    return 0 if all(g < 0.10 for g in crit) else 1


if __name__ == "__main__":
    sys.exit(main())
