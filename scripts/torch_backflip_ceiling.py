"""Measured reward ceiling of a chaotic clip (backflip by default), on the
PyTorch port.

The counterpart of ``scripts/backflip_ceiling.py``, in three parts:

(a) the pipeline check: the reference (qpos, qvel) scored against itself
    through the eval reward, about 1.0 by construction (what is left below
    1.0 comes from the clip's resampling and interpolation);
(b) the timing-error envelope: the reference scored against itself shifted
    by 1, 2 and 4 physics substeps and 1 and 2 clip frames, what a
    controller that reproduces the motion perfectly but that much late
    would earn, per term; the 1-frame row bounds what feedback tracking of
    a chaotic flip can earn;
(c) the policy's decomposition: the deterministic rollout of
    ``scripts/torch_diag_rollout.py`` (from clip time 0), its per-term
    rewards, its joint-velocity RMSE against the reference, and the
    velocity term at that RMSE.

(a) and (b) score the six shifts' ``--steps`` reference times each as one
batch: body poses from the env's kinematics, rewards from the env's reward
with no fall. (c) runs one env for ``--steps`` steps, each one launch of the
policy-step kernel on the card (``--device``, the card by default). The
policy is ``--checkpoint-dir``'s (a port run) or ``--clip``'s bundled
export. It prints one JSON line (``--out`` also writes it):

    python scripts/torch_backflip_ceiling.py --clip backflip --steps 256
    python scripts/torch_backflip_ceiling.py --device cpu --steps 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def shifts(cfg, clip):
    """(name, seconds) of the envelope's rows."""
    sub, frame = float(cfg.physics_dt), float(clip.dt)
    return [("exact", 0.0), ("1 substep", sub), ("2 substeps", 2 * sub),
            ("4 substeps", 4 * sub), ("1 frame", frame), ("2 frames", 2 * frame)]


def score(env, steps: int):
    """The reference at ``t + shift`` scored at ``t``, for ``steps`` times
    ``t = k * policy_dt`` and every shift, in one batch: (rows, reward
    (shifts, steps), terms {name: (shifts, steps)})."""
    import torch

    from pbrl_tpu_torch.envs import humanoid_task as task
    from pbrl_tpu_torch.mocap import reference_state

    rows = shifts(env.config, env.clip)
    t = np.arange(steps) * float(env.config.effective_policy_dt)
    dev = env.device
    t_score = torch.as_tensor(np.tile(t, len(rows)), dtype=torch.float32, device=dev)
    t_ref = torch.as_tensor(np.concatenate([t + d for _, d in rows]), dtype=torch.float32,
                            device=dev)
    with torch.no_grad():
        q, v = reference_state(env.clip, t_ref)
        xpos, xquat = task.body_frames(env.model, q, v)
        r, terms = task.reward(env.model, env.clip, env.config, q, v, t_score,
                               reference_state(env.clip, t_score), xpos, xquat,
                               torch.zeros_like(t_score))
    return rows, r.reshape(len(rows), steps), {k: x.reshape(len(rows), steps)
                                               for k, x in terms.items()}


def envelope(env, steps: int) -> dict:
    """(a)-(b): each shift's mean reward and terms over ``steps`` reference
    times."""
    rows, r, terms = score(env, steps)

    def means(x):
        return x.double().mean(dim=1).cpu().numpy()

    r = means(r)
    terms = {k: means(terms[k]) for k in sorted(terms)}
    return {name: {"delta_ms": round(d * 1e3, 2), "reward": round(float(r[i]), 4),
                   **{k: round(float(x[i]), 4) for k, x in terms.items()}}
            for i, (name, d) in enumerate(rows)}


def checkpoint_terms(env, rec) -> dict:
    """(c): the rollout's reward, terms and joint-velocity error."""
    import torch

    from pbrl_tpu_torch.mocap import reference_state

    from torch_diag_rollout import TERMS

    t = torch.as_tensor(rec["time"], device=env.device)
    v_ref = reference_state(env.clip, t)[1].cpu().numpy()
    dv = rec["qvel"] - v_ref
    vel_sq_mean = float(np.mean(np.sum(dv ** 2, axis=1)))
    return {
        "mean_reward": round(float(rec["reward"].mean()), 4),
        "terms_mean": {k: round(float(rec["terms"][:, j].mean()), 4)
                       for j, k in enumerate(TERMS)},
        "qvel_rmse_per_dof": round(float(np.sqrt(np.mean(dv ** 2))), 3),
        "ref_qvel_rms_per_dof": round(float(np.sqrt(np.mean(v_ref ** 2))), 3),
        "sum_dv_sq_mean": round(vel_sq_mean, 1),
        "r_vel_at_checkpoint_rmse": float(np.exp(-env.config.s_vel * vel_sq_mean)),
    }


def ceiling(clip=None, checkpoint_dir=None, steps: int = 256, device="cuda") -> dict:
    """The tool's JSON record; the clip is ``clip``, else the run's, else
    backflip."""
    from torch_diag_rollout import diag_rollout

    if clip is None and checkpoint_dir is None:
        clip = "backflip"
    env, rec = diag_rollout(clip, checkpoint_dir, steps, device)
    env_rows = envelope(env, steps)
    ckpt = checkpoint_terms(env, rec)
    cfg = env.config
    # per-term achievable: the 1-frame timing-error envelope; weights from the eval config
    one = env_rows["1 frame"]
    ceil = (cfg.w_pose * one["reward_pose"] + cfg.w_vel * one["reward_vel"]
            + cfg.w_ee * one["reward_ee"] + cfg.w_com * one["reward_com"])
    return {
        "clip": env.clip.name,
        "weights": {"pose": cfg.w_pose, "vel": cfg.w_vel, "ee": cfg.w_ee, "com": cfg.w_com},
        "kernel_scales": {"s_pose": cfg.s_pose, "s_vel": cfg.s_vel, "s_ee": cfg.s_ee,
                          "s_com": cfg.s_com},
        "envelope": env_rows,
        "checkpoint": ckpt,
        "ceiling_at_1frame_timing": round(float(ceil), 4),
        "eval_fraction_of_ceiling": round(float(ckpt["mean_reward"]) / float(ceil), 4)
        if ceil else None,
        "launches": env._kstep.launches,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clip", default=None,
                    help="a shipped clip (default: the run's, else backflip)")
    ap.add_argument("--checkpoint-dir", default=None, help="a run directory of the port")
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from pbrl_tpu_torch.cli import _require_device

    _require_device(args.device)
    out = ceiling(args.clip, args.checkpoint_dir, args.steps, args.device)
    for name, row in out["envelope"].items():
        print(f"[envelope] {name:>10} ({row['delta_ms']:5.1f} ms): {row}", file=sys.stderr)
    print(f"[ckpt] {out['checkpoint']}", file=sys.stderr)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
