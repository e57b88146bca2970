"""Phase-aligned diagnostic rollout on the PyTorch port: the deterministic
policy from the clip's start (time 0, no reference-state init), with
per-step reward, time and root pose against the reference.

The counterpart of ``scripts/diag_rollout.py``. The policy is a port run's
latest checkpoint (``--checkpoint-dir``) or ``--clip``'s bundled export;
the env is its eval-stripped run config (as ``cli eval`` builds it) with
``reference_state_init`` off. One env runs
``--steps`` steps of the policy's mean action with no reset, each step one
launch of the policy-step kernel on the card (``--device``, the card by
default). It writes ``qpos``, ``reward``, ``done``, ``time``, ``root_err``
and ``qpos_ref`` to ``--out`` and prints one JSON line: the mean reward,
the steps alive, per clip cycle the mean reward, root xy error, root
height apex and root rotation error, the reward terms' means, and the
kernel's ``launches``:

    python scripts/torch_diag_rollout.py --clip backflip --steps 256 --out diag.npz
    python scripts/torch_diag_rollout.py --checkpoint-dir runs/walk --steps 300
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TERMS = ("pose", "vel", "ee", "com")  # cli.REWARD_TERMS, as pbrl_tpu's script names them


def diag_rollout(clip=None, checkpoint_dir=None, steps: int = 300, device="cuda"):
    """(env, record): the policy's ``steps``-step rollout of one env from
    clip time 0 (:func:`pbrl_tpu_torch.cli.rollout_trajectory`'s arrays, with
    ``qpos_ref``, the reference pose at each step's time)."""
    import torch

    from pbrl_tpu_torch.cli import _normalize_obs, _policy_env, rollout_trajectory
    from pbrl_tpu_torch.mocap import reference_state

    args = argparse.Namespace(checkpoint_dir=checkpoint_dir, clip=clip, policy=None,
                              device=device,
                              env_set=["reference_state_init=false"])
    policy, stats, run, env = _policy_env(args)
    state = env.reset(1)
    rec = rollout_trajectory(env, policy, stats, state, steps, _normalize_obs(run))
    t = torch.as_tensor(rec["time"], device=env.device)
    rec["qpos_ref"] = reference_state(env.clip, t)[0].cpu().numpy()
    return env, rec


def summary(env, rec) -> dict:
    """pbrl_tpu's diagnostic line of a record, with the kernel's launches."""
    qpos, rew, done, q_ref = rec["qpos"], rec["reward"], rec["done"], rec["qpos_ref"]
    root_err, terms = rec["root_err"], rec["terms"]
    steps = qpos.shape[0]
    dxy = np.linalg.norm(qpos[:, :2] - q_ref[:, :2], axis=1)
    cyc = max(1, int(round(float(env.clip.cycle_time) / env.config.effective_policy_dt)))
    ncyc = steps // cyc

    def by_cycle(x, fn=np.mean, nd=3):
        return [round(float(fn(x[i * cyc:(i + 1) * cyc])), nd) for i in range(ncyc)]

    return {
        "mean_reward": round(float(rew.mean()), 4),
        "alive": steps if not done.any() else int(np.argmax(done > 0)),
        "cycle_steps": cyc,
        "reward_by_cycle": by_cycle(rew),
        "xy_err_by_cycle": by_cycle(dxy),
        "z_apex_by_cycle": by_cycle(qpos[:, 2], np.max),
        "ref_z_apex": round(float(q_ref[:cyc, 2].max()), 3),
        "root_err_by_cycle": by_cycle(root_err),
        "terms_mean": {k: round(float(terms[:, j].mean()), 3) for j, k in enumerate(TERMS)},
        "terms_cycle1": {k: round(float(terms[:cyc, j].mean()), 3)
                         for j, k in enumerate(TERMS)},
        "launches": env._kstep.launches,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clip", default=None, help="a shipped clip (default: the run's, or walk)")
    ap.add_argument("--checkpoint-dir", default=None, help="a run directory of the port")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default="diag.npz")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from pbrl_tpu_torch.cli import _require_device

    _require_device(args.device)
    env, rec = diag_rollout(args.clip, args.checkpoint_dir, args.steps, args.device)
    np.savez(args.out, **{k: rec[k] for k in ("qpos", "reward", "done", "time", "root_err",
                                              "qpos_ref")})
    print(json.dumps(summary(env, rec)))
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
