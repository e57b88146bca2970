"""Eval by start phase on the PyTorch port: the deterministic policy from a
grid of clip phases (the distribution ``cli eval`` samples uniformly), with
reward, episode length and pose error per start phase. It shows where the
eval's mean loses reward, e.g. mid-air starts against ground starts.

The counterpart of ``scripts/phase_eval.py``. Each phase is one call of
``ppo.evaluate(..., num_envs=1, t0=[t])`` at the clip's eval-stripped run
config (as ``cli eval``), so its numbers are the eval's own: the reward is
the mean over the steps before the episode's end (pbrl_tpu's script
averages over all steps, counting the ended ones as 0). Policies: the
clip's bundled export, or ``--checkpoint-dir``. On the card by default:

    python scripts/torch_phase_eval.py --clip backflip --phases 16 --steps 256
    python scripts/torch_phase_eval.py --device cpu --clip walk --phases 2 --steps 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def phase_grid(clip, phases: int):
    """``phases`` start times spread evenly over the clip's RSI range (the
    cycle for a looping clip, its first 90% otherwise), float32 as a reset
    takes them."""
    import numpy as np

    hi = float(clip.cycle_time) if clip.loop else 0.9 * float(clip.cycle_time)
    return np.linspace(0.0, hi, phases, endpoint=False).astype(np.float32)


def phase_eval(clip=None, checkpoint_dir=None, phases: int = 16, steps: int = 256,
               device="cuda") -> dict:
    import numpy as np
    import torch

    from pbrl_tpu_torch.cli import _normalize_obs, _policy_env
    from pbrl_tpu_torch.train import evaluate

    args = argparse.Namespace(checkpoint_dir=checkpoint_dir, clip=clip, policy=None,
                              device=device, env_set=[])
    policy, stats, run, env = _policy_env(args)
    rows = []
    for t0 in phase_grid(env.clip, phases):
        m = evaluate(env, policy, stats, num_envs=1, num_steps=steps,
                     t0=torch.tensor([t0], device=device), normalize_obs=_normalize_obs(run))
        m = {k: float(v) for k, v in m.items()}
        rows.append({"phase": float(t0) / float(env.clip.cycle_time), "t0": float(t0),
                     "reward": m["eval_reward"], "ep_len": m["eval_episode_length"],
                     "pose_error": m["eval_pose_error"]})
    return {"clip": env.clip.name, "checkpoint": checkpoint_dir or "bundled", "steps": steps,
            "mean_reward": float(np.mean([r["reward"] for r in rows])),
            "mean_ep_len": float(np.mean([r["ep_len"] for r in rows])), "per_phase": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clip", default=None, help="a shipped clip (default: the run's, or walk)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--phases", type=int, default=16)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from pbrl_tpu_torch.cli import _require_device

    _require_device(args.device)
    print(json.dumps(phase_eval(args.clip, args.checkpoint_dir, args.phases, args.steps,
                                args.device), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
