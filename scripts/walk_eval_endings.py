"""Run eval envs of a shipped clip from given start times through pbrl_tpu
and the port.

Both sides run the clip's deterministic policy (the exported
``pbrl_tpu_torch/assets/<clip>_policy.npz``, walk's by default, ``--clip``)
on the CPU, from the same reference start states, with the eval's env
config (the clip's run config, with the training-only perturbations
stripped as both ``eval`` commands strip them):

* pbrl_tpu's ``MimicVecEnv``, its physics through pbrl_tpu's field program
  (``pbrl_tpu.ops.field_physics``, the kernel's own math) run eagerly
  (``--sides field``: XLA takes too long to compile it on the CPU; about
  20 s per policy step), and through its einsum engine, jitted
  (``--sides engine``, ``backend="xla"``);
* the port's ``MimicVecEnv``, its physics through the plain version of the
  kernel (``--sides port``, ``mimic_step_plain``; about 2.6 s per policy
  step), or on the card through the kernel (``--sides kernel``, the only
  side that runs where JAX is not installed).

For each side it prints how many envs end early and the mean live steps
(as the eval counts them); with ``--t0``, for each env at which step its
episode ends on each side (the first ``done``), whether the fall flag
ended it, and how fast pbrl_tpu's qpos drifts from the port's. It tells a
fault of the port from a fall that the reference shares.

    JAX_PLATFORMS=cpu python scripts/walk_eval_endings.py --steps 300 \\
        --sides port engine field --t0 0x1.1p+0 0x1.8p-2
    JAX_PLATFORMS=cpu python scripts/walk_eval_endings.py --sides engine --grid 4096
    python scripts/walk_eval_endings.py --sides kernel --grid 4096   # on the card
    JAX_PLATFORMS=cpu python scripts/walk_eval_endings.py --clip jump --steps 256 \\
        --sides engine --grid 1024
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _float(x: str) -> float:
    return float.fromhex(x) if "0x" in x else float(x)


def jax_side(clip, run, t0, steps, physics_mode):
    import jax
    import jax.numpy as jnp

    from pbrl_tpu.envs import EnvConfig, MimicVecEnv
    from pbrl_tpu.mocap import load_clip, reference_state
    from pbrl_tpu.mocap.skeleton import generate_kp_kd_gains
    from pbrl_tpu.model import humanoid_model
    from pbrl_tpu.ops import field_physics as fp
    from pbrl_tpu.train import running_stats
    from pbrl_tpu.train.networks import PolicyNetwork
    from pbrl_tpu.utils.configio import dict_to_config

    from pbrl_tpu_torch.cli import _env_config

    cfg = dict_to_config(EnvConfig, {k: list(v) if isinstance(v, tuple) else v for k, v in
                                     vars(_env_config(run)).items()})
    env = MimicVecEnv(humanoid_model(), load_clip(clip), cfg, backend="xla")
    kp, kd = generate_kp_kd_gains()
    spec = fp.build_spec(env.model, kp=kp, kd=kd, n_substeps=cfg.n_substeps, mode="pd",
                         fall_allowed_bodies=("right_ankle", "left_ankle"),
                         torque_scale=cfg.torque_limit_scale)

    def physics(qpos, qvel, u):
        rows = lambda a: [a[:, i] for i in range(a.shape[1])]
        q, v, fall, held = fp.substep(spec, rows(qpos), rows(qvel), rows(u))

        for _ in range(1, spec.n_substeps):
            q, v, f, _ = fp.substep(spec, q, v, rows(u), held_self=held or None)
            fall = jnp.maximum(fall, f)
        xp, xq = fp.fk_outputs(spec, q)
        B = qpos.shape[0]
        return (jnp.stack(q, 1), jnp.stack(v, 1),
                jnp.stack([jnp.stack(p, 1) for p in xp], 1).reshape(B, -1, 3),
                jnp.stack([jnp.stack(r, 1) for r in xq], 1).reshape(B, -1, 4), fall)

    if physics_mode == "field":
        env._physics = physics  # run eagerly: XLA takes too long to compile it on the CPU
    with np.load(f"pbrl_tpu_torch/assets/{clip}_policy.npz") as z:
        tree = {}
        for k in z.files:
            if k.startswith("policy/"):
                node = tree
                parts = k.split("/")[1:]
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(z[k])
        stats = running_stats.RunningStats(**{k: jnp.asarray(z[f"obs_stats/{k}"])
                                              for k in ("count", "mean", "m2")})
    net = PolicyNetwork(action_size=28)
    B = len(t0)
    state = env.reset(jax.random.split(jax.random.PRNGKey(0), B))
    tt = jnp.asarray(t0, jnp.float32)
    qpos, qvel = jax.vmap(lambda x: reference_state(env.clip, x))(tt)
    state = state.replace(qpos=qpos, qvel=qvel, time=tt, episode_start=tt,
                          obs=env._obs(qpos, qvel, tt))

    def step(state):
        mean, _ = net.apply({"params": tree}, running_stats.normalize(stats, state.obs))
        return env.step(state, mean)

    if physics_mode == "engine":
        step = jax.jit(step)

    qs, dones, falls = [], [], []
    for _ in range(steps):
        state = step(state)
        qs.append(np.asarray(state.qpos))
        dones.append(np.asarray(state.done))
        falls.append(np.asarray(state.metrics["fall"]))
    return np.stack(qs), np.stack(dones), np.stack(falls)


def torch_side(clip, run, t0, steps, device):
    import torch

    from pbrl_tpu_torch.cli import _env_config
    from pbrl_tpu_torch.envs import MimicVecEnv
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.model import humanoid_model
    from pbrl_tpu_torch.train import checkpoint, running_stats

    policy, stats, _ = checkpoint.load_policy(checkpoint.bundled_policy(clip), device=device)
    env = MimicVecEnv(humanoid_model(), load_clip(clip, device=device), _env_config(run),
                      device=device)
    state = env.reset(len(t0), t0=torch.tensor(t0, dtype=torch.float32, device=device))
    qs, dones, falls = [], [], []
    with torch.no_grad():
        for _ in range(steps):
            mean, _ = policy(running_stats.normalize(stats, state.obs))
            state = env.step(state, mean)
            qs.append(state.qpos.cpu().numpy())
            dones.append(state.done.cpu().numpy())
            falls.append(state.metrics["fall"].cpu().numpy())
    return np.stack(qs), np.stack(dones), np.stack(falls)


def first_end(done):
    ended = done > 0
    return [int(np.argmax(ended[:, j])) if ended[:, j].any() else None
            for j in range(done.shape[1])]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    start = ap.add_mutually_exclusive_group(required=True)
    start.add_argument("--t0", nargs="+", help="start times (float or hex)")
    start.add_argument("--grid", type=int, help="this many start times spread evenly "
                       "over the clip's cycle (a summary per side, no per-env rows)")
    ap.add_argument("--clip", default="walk", help="a shipped clip with a bundled policy")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--sides", nargs="+", default=["port", "engine", "field"],
                    choices=["port", "kernel", "engine", "field"],
                    help="port: the plain version on the CPU; kernel: the port on the card "
                    "(needs no JAX); engine, field: pbrl_tpu on the CPU")
    args = ap.parse_args(argv)

    if {"engine", "field"} & set(args.sides):
        import jax

        jax.config.update("jax_platforms", "cpu")
    from pbrl_tpu_torch.mocap import load_clip
    from pbrl_tpu_torch.train import checkpoint

    run = checkpoint.load_policy(checkpoint.bundled_policy(args.clip), device="cpu")[2]
    if args.grid:
        cycle = float(load_clip(args.clip, device="cpu").cycle_time)
        t0 = [float(np.float32(cycle * i / args.grid)) for i in range(args.grid)]
    else:
        t0 = [_float(x) for x in args.t0]
    sides = {}
    for side in args.sides:
        t = time.perf_counter()
        if side in ("port", "kernel"):
            sides[side] = torch_side(args.clip, run, t0, args.steps,
                                     "cpu" if side == "port" else "cuda")
        else:
            sides[side] = jax_side(args.clip, run, t0, args.steps, side)
        ends = first_end(sides[side][1])
        early = [(x, e) for x, e in zip(t0, ends) if e is not None]
        print(json.dumps({"side": side, "seconds": time.perf_counter() - t,
                          "envs": len(t0), "steps": args.steps, "ended_early": len(early),
                          "mean_live_steps": sum(args.steps if e is None else e
                                                 for e in ends) / len(t0),
                          "early": early}), flush=True)
    if args.grid or "port" not in sides:
        return 0
    tq = sides["port"][0]
    ends = {k: first_end(d) for k, (_, d, _) in sides.items()}
    for j, x in enumerate(t0):
        row = {"t0": x, "t0_hex": x.hex()}
        for k, (q, _, f) in sides.items():
            e = ends[k][j]
            row[f"{k}_live_steps"] = e
            row[f"{k}_fall"] = None if e is None else bool(f[e, j] > 0)
            if k != "port":
                # how the two sides drift apart: the first 10 steps, and the
                # first step at which qpos differs by more than 1e-2
                dq = np.abs(q[:, j] - tq[:, j]).max(axis=1)
                row[f"{k}_max_dqpos_10_steps"] = float(dq[:10].max())
                big = np.nonzero(dq > 1e-2)[0]
                row[f"{k}_dqpos_over_1e-2_at"] = int(big[0]) if big.size else None
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
